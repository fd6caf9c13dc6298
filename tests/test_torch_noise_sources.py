"""The port's counter-based and device-built noise sources against the JAX
package's, on the CPU.

The port writes threefry2x32, ``jax.random.normal``'s uniform conversion
and XLA's float32 erfinv in plain torch ops (ops/noise.py). Tolerances,
fixed before the comparison:

* threefry words (``fold_in``, ``bits``): bit for bit;
* normals (``VirtualNoise`` rows, ``NoiseTable.from_key``): 1e-6 absolute
  (read: 4.8e-7 at most over 2²⁰ draws, on about 1% of them, up to three
  float32 ulps where |x| < 1: XLA's float32 log1p rounds otherwise than the
  port's float64 one);
* the gradient over a VirtualNoise: 1e-5·max|g| (float32 sums in another
  order over rows that differ by an ulp);
* one ES generation on the maze over a VirtualNoise, the JAX draws fed in:
  as tests/test_torch_rollout.py holds the table's;
* GA genomes over a VirtualNoise: 1e-6·max|θ|.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import NoCudaDevice, weights
from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.ops import fitness as tfit
from deep_neuroevolution_torch.ops import genome as tgenome
from deep_neuroevolution_torch.ops import noise as tnoise
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.utils import checkpoint as tckpt
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import genome as jgenome
from deep_neuroevolution_tpu.ops import noise as jnoise
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.utils import checkpoint as jckpt
from deep_neuroevolution_tpu.utils import config as jconfig
from deep_neuroevolution_tpu.utils import tabular as jtab

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
NORMAL_TOL = 1e-6
SEEDS = (0, 123, 2**31 + 5, 2**32 + 7)  # ≥ 2³¹, and one the 32-bit mode wraps


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jkey(key) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


# --------------------------------------------------------------- threefry


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    assert tnoise.prng_key(seed) == _jkey(key)
    for d in (0, 1, 7, 2**31 - 2, 2**31 - 1, 2**31, 2**32 - 1):
        assert tnoise.fold_in(tnoise.prng_key(seed), d) == _jkey(jax.random.fold_in(key, np.uint32(d))), d


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dim", (1, 7, 8, 1001))
def test_bits_bit_for_bit(seed, dim):
    """``bits(fold_in(key, i), dim)`` for stream ids near 2³¹, odd and even
    ``dim``."""
    key = jax.random.PRNGKey(seed)
    for i in (0, 5, 2**31 - 1):
        j = np.asarray(jax.random.bits(jax.random.fold_in(key, np.uint32(i)), (dim,))).astype(np.int64)
        t = tnoise.bits(tnoise.fold_in(tnoise.prng_key(seed), i), dim, device="cpu").numpy()
        np.testing.assert_array_equal(t, j)


def test_normals_within_a_few_ulps():
    """2¹⁶ draws within 1e-6; each at most three float32 ulps apart."""
    key = jax.random.PRNGKey(7)
    n = 1 << 16
    j = np.asarray(jax.random.normal(key, (n,), jnp.float32))
    t = tnoise.normal(_jkey(key), n, device="cpu").numpy()
    assert t.dtype == np.float32
    d = np.abs(t - j)
    assert d.max() <= NORMAL_TOL
    assert (d <= 3 * np.spacing(np.abs(j))).all()
    print(f"normals: max |Δ| {d.max():.3g}, {int((d > 0).sum())} of {n} differ")


# ---------------------------------------------------------------- sources


@pytest.mark.parametrize("dim", (7, 1000, 4097))
def test_virtual_noise_rows(dim):
    jv = jnoise.VirtualNoise.from_seed(count=10**6)
    tv = tnoise.VirtualNoise.from_seed(count=10**6, device="cpu")
    idx = np.array([0, 5, 2**31 - 1, 999_000, 12345], np.int32)
    j = np.asarray(jv.get_batch(jnp.asarray(idx), dim))
    t = tv.get_batch(torch.from_numpy(idx), dim).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=NORMAL_TOL)
    np.testing.assert_allclose(tv.get(12345, dim).numpy(), np.asarray(jv.get(jnp.int32(12345), dim)),
                               rtol=0, atol=NORMAL_TOL)
    np.testing.assert_array_equal(tnoise.noise_rows(tv, torch.from_numpy(idx), dim).numpy(), t)
    assert tv.size == jv.size == 10**6


def test_from_key_table():
    """The device-built table, 1M floats, on the CPU here."""
    count = 1_000_000
    j = np.asarray(jnoise.NoiseTable.from_key(jax.random.PRNGKey(123), count=count).noise)
    t = tnoise.NoiseTable.from_key(tnoise.prng_key(123), count=count, device="cpu")
    assert t.size == count and t.noise.dtype == torch.float32
    d = np.abs(t.noise.numpy() - j)
    print(f"from_key: max |Δ| {d.max():.3g}, {int((d > 0).sum())} of {count} differ")
    assert d.max() <= NORMAL_TOL


def test_new_sources_need_a_card_by_default(monkeypatch):
    """Every way to a threefry source or stream runs on cuda unless told
    otherwise: a ``VirtualNoise`` names its device (``None`` is cuda)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDevice):
        tnoise.VirtualNoise.from_seed(count=1000)
    with pytest.raises(NoCudaDevice):
        tnoise.VirtualNoise((0, 1), 1000, device=None)
    with pytest.raises(TypeError):
        tnoise.VirtualNoise((0, 1), 1000)  # no default device
    with pytest.raises(NoCudaDevice):
        tnoise.VirtualNoise.from_seed(count=1000, device="cpu").to(None)
    with pytest.raises(NoCudaDevice):
        tnoise.NoiseTable.from_key((0, 1), count=1000)
    with pytest.raises(NoCudaDevice):
        tnoise.normal((0, 1), 10)
    with pytest.raises(NoCudaDevice):
        tnoise.bits((0, 1), 10)
    assert tnoise.VirtualNoise((0, 1), 1000, device="cpu").device == torch.device("cpu")


def test_sampled_ids_in_range():
    tv = tnoise.VirtualNoise.from_seed(count=1000, device="cpu")
    idx = tv.sample_index_batch(torch.Generator().manual_seed(0), 900, 5000)
    assert idx.dtype == torch.int32 and int(idx.min()) == 0 and int(idx.max()) == 100
    table = tnoise.NoiseTable(torch.zeros(1000))  # a table of the same size draws the same offsets
    assert torch.equal(idx, table.sample_index_batch(torch.Generator().manual_seed(0), 900, 5000))


def test_table_source_rows_match_its_tensor():
    """``noise_rows`` and the gradient on a ``NoiseTable`` object and on its
    bare tensor: the same rows, an offset past the last valid start clamped
    as the JAX package's ``noise_rows`` clamps it."""
    count, dim = 5000, 1000
    jt = jnoise.NoiseTable.from_seed(count=count)
    tt = tnoise.NoiseTable.from_seed(count=count)
    idx = np.array([0, 17, count - dim, count - dim + 5], np.int32)
    j = np.asarray(jnoise.noise_rows(jt.noise, jnp.asarray(idx), dim))
    for src in (tt, tt.noise):
        np.testing.assert_array_equal(tnoise.noise_rows(src, torch.from_numpy(idx), dim).numpy(), j)
    w = torch.linspace(-1, 1, 4)
    np.testing.assert_array_equal(tfit.gradient_from_noise(tt, torch.from_numpy(idx), w, dim).numpy(),
                                  tfit.gradient_from_noise(tt.noise, torch.from_numpy(idx), w, dim).numpy())


def test_gradient_over_virtual_noise():
    dim, n = 3001, 37
    jv = jnoise.VirtualNoise.from_seed(count=10**6)
    tv = tnoise.VirtualNoise.from_seed(count=10**6, device="cpu")
    rs = np.random.RandomState(0)
    idx = rs.randint(0, 10**6 - dim, n).astype(np.int32)
    w = rs.randn(n).astype(np.float32)
    j = np.asarray(jfit.gradient_from_noise(jv, jnp.asarray(idx), jnp.asarray(w), dim, 16))
    t = tfit.gradient_from_noise(tv, torch.from_numpy(idx), torch.from_numpy(w), dim, 16).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())


# ------------------------------------------------------- trainers and genomes


class _InjectedES(tes.ESTrainer):
    """The port's trainer, handed each round's stream ids and the reset
    states of the round and the eval episodes."""

    def __init__(self, *a, rounds, starts, **kw):
        super().__init__(*a, **kw)
        self._rounds, self._starts = list(rounds), dict(starts)

    def _draw_round(self, npairs):
        return torch.from_numpy(np.array(self._rounds.pop(0))), 0

    def _episode_starts(self, seed, n, paired):
        return self._starts.pop("round" if paired else "eval"), self._episode_gen(seed)


def _to_torch_state(tenv, jstate):
    cls = type(tenv.reset(1, torch.Generator(), CPU))
    return cls(*(torch.from_numpy(np.array(f)) for f in jstate))


def test_es_generation_on_virtual_noise(monkeypatch):
    """One maze generation (population 16, cutoff 30) over a VirtualNoise,
    the JAX package's draws fed in: returns and lengths within rtol 1e-5 /
    atol 1e-4, g within 1e-5·max|g|, θ' by tests/test_torch_es.py's rule;
    the gradient never reaches K2."""
    monkeypatch.setattr(jtab, "dump_tabular", lambda: jtab._logger._kvs.clear())
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
    count, pop, cutoff, npairs, lr = 10**6, 16, 30, 8, 0.05
    jenv, tenv = jenvs.make("maze"), tenvs.make("maze")
    kw = dict(obs_dim=11, ac_dim=2)
    jm, tm = jmodels.ContinuousMLP(**kw), tmodels.ContinuousMLP(**kw)
    cfg = dict(population_size=pop, episode_cutoff_mode=cutoff, noise_stdev=0.05)
    jtr = jes.ESTrainer(jenv, jm, jes.ESConfig(**cfg), optimizer=jopt.Adam(stepsize=lr),
                        noise_table=jnoise.VirtualNoise.from_seed(count=count), seed=3)
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    jstats = jtr.train_step()
    key, keval = jax.random.split(key)
    key, kround = jax.random.split(key)
    kidx, kroll = jax.random.split(jax.random.split(kround, 1)[0])
    idxs = np.asarray(jax.random.randint(kidx, (npairs,), 0, count - jm.num_params + 1, dtype=jnp.int32))
    ep_seeds = jax.random.randint(kroll, (npairs,), 0, 2**31 - 1, dtype=jnp.int32)
    keys = jax.vmap(lambda s: jax.random.PRNGKey(s.astype(jnp.uint32)))(ep_seeds)
    starts = {
        "round": _to_torch_state(tenv, jax.vmap(jenv.reset)(jnp.concatenate([keys, keys]))),
        "eval": _to_torch_state(tenv, jax.vmap(jenv.reset)(jax.random.split(keval, 8))),
    }
    calls = []
    monkeypatch.setattr(tes, "noise_gradient", lambda *a: calls.append(a))
    ttr = _InjectedES(tenv, tm, tes.ESConfig(**cfg), optimizer=topt.Adam(stepsize=lr),
                      noise_table=tnoise.VirtualNoise.from_seed(count=count, device="cpu"), seed=3, device="cpu",
                      rounds=[idxs], starts=starts)
    ttr.theta = weights.from_jax(theta0, device="cpu")
    tstats = ttr.train_step()
    assert not calls and isinstance(ttr.noise, tnoise.VirtualNoise)
    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    np.testing.assert_allclose(tstats.returns, jstats.returns, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tstats.eval_returns, np.asarray(jstats.eval_returns), rtol=1e-5, atol=1e-4)
    srets = np.zeros_like(jstats.returns)
    jw = jfit.process_returns(jnp.asarray(jstats.returns), jnp.asarray(srets), "centered_rank")
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise, jnp.asarray(idxs), jw[:, 0] - jw[:, 1],
                                             jm.num_params)) / jstats.returns.size
    gmax = np.abs(jg).max()
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + 0.005 * theta0
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(G) + eps_) ** 2 < 1e-6
    ttheta, jtheta = ttr.theta.numpy(), np.asarray(jtr.state.theta)
    np.testing.assert_allclose(ttheta[steady], jtheta[steady], rtol=0, atol=1e-6)
    assert steady.mean() > 0.9


@pytest.mark.parametrize("style", ["gpu", "cpu"])
def test_ga_genomes_on_virtual_noise(style):
    """A chain's θ over a VirtualNoise: the JAX package's genome functions
    (GPU-style, and its trainer's CPU-style ``_reconstruct``) against the
    port's ``theta_from_seed_chain`` and the GA's cached-prefix step, within
    1e-6·max|θ|."""
    from deep_neuroevolution_tpu.algos import ga as jga

    count, dim_model = 10**6, dict(obs_dim=4, num_actions=2)
    jm, tm = jmodels.SimpleClassifier(**dim_model), tmodels.SimpleClassifier(**dim_model)
    jv = jnoise.VirtualNoise.from_seed(count=count)
    tv = tnoise.VirtualNoise.from_seed(count=count, device="cpu")
    D = jm.num_params
    if style == "gpu":
        chain = (2024, (77777, 0.01), (31337, 0.02), (2**31 - 1 - D, 0.005))
        idxs, powers = jgenome.pad_chains([chain], len(chain))
        j = np.asarray(jgenome.reconstruct_gpu_style(jv, idxs[0], powers[0], D, jm.scale_by("fan_in")))
    else:
        chain = (2024, 77777, 31337)
        jtr = jga.GATrainer(jenvs.make("gym.CartPole-v1"), jm,
                            jga.GAConfig(genome_style="cpu", noise_stdev=0.01, population_size=4), noise_table=jv)
        j = np.asarray(jtr._reconstruct(chain))
    t = tckpt.theta_from_seed_chain(tm, tv, chain, style, 0.01).numpy()
    if style == "gpu":  # the JAX package's own helper reads a table's .noise (ROADMAP Queue 3)
        with pytest.raises(AttributeError, match="noise"):
            jckpt.theta_from_seed_chain(jm, jv, chain, "gpu")
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * np.abs(j).max())
    # the GA's one-step extension of a cached parent (a FMA, as XLA's)
    ttr = tga.GATrainer(tenvs.make("gym.CartPole-v1"), tm,
                        tga.GAConfig(genome_style=style, noise_stdev=0.01, population_size=4),
                        noise_table=tv, device="cpu")
    ttr.cached_parent_seeds = [chain[:-1]]
    ttr.cached_parent_thetas = tckpt.theta_from_seed_chain(tm, tv, chain[:-1], style, 0.01)[None]
    np.testing.assert_allclose(ttr._lookup_theta(chain).numpy(), j, rtol=0, atol=1e-6 * np.abs(j).max())
    np.testing.assert_array_equal(tgenome.extend(torch.zeros(D), tv, 5, 1.0, D).numpy(), tv.get(5, D).numpy())


def _exp(name):
    return json.loads((ROOT / "configurations" / name).read_text())


@pytest.mark.parametrize("noise", ["virtual", "device"])
def test_loader_noise_overrides(noise, monkeypatch):
    """``noise`` / ``noise_seed`` give the JAX package's source types and
    sizes; the 'device' table agrees within 1e-6 (its first 100k floats)."""
    monkeypatch.setattr(jtab, "dump_tabular", lambda: None)
    over = {"noise": noise, "noise_size": 200_000}
    if noise == "device":
        over["noise_seed"] = 7
    exp = _exp("maze_es.json")
    jtr = jconfig.load_experiment(exp, overrides=over)
    ttr = tconfig.load_experiment(exp, overrides=over, device="cpu")
    assert type(ttr.noise).__name__ == type(jtr.noise).__name__
    assert ttr.noise.size == jtr.noise.size == 200_000
    if noise == "device":
        np.testing.assert_allclose(ttr.noise.noise[:100_000].numpy(), np.asarray(jtr.noise.noise[:100_000]),
                                   rtol=0, atol=NORMAL_TOL)
    else:
        assert ttr.noise.key == _jkey(jtr.noise.key)
    ga = tconfig.load_experiment(exp, algo="ga", overrides=over, device="cpu")
    assert type(ga.noise).__name__ == type(jtr.noise).__name__


def test_loader_refuses_unknown_noise():
    exp = _exp("maze_es.json")
    with pytest.raises(ValueError, match="unknown noise source"):
        tconfig.load_experiment(exp, overrides={"noise": "table"}, device="cpu")
    with pytest.raises(ValueError, match="noise_seed"):
        tconfig.load_experiment(exp, overrides={"noise": "virtual", "noise_seed": 3}, device="cpu")
