"""One fixed-population ES generation of the port against the JAX package's
ESTrainer on the ToyCatch engine, on the CPU.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX trainer drew: the initial θ, the reference batch, each round's
noise offsets and rollout seed, and the eval episodes' rollout seed (from
which both packages draw the noop counts and the engine's episode seeds in
the same order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos.rollout_host import collect_ref_batch_host, rollout_host_batch
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.models import VirtualBNDQN as TorchVBN
from deep_neuroevolution_torch.ops import fitness as tfit
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos.rollout_host import collect_ref_batch_host as jax_collect_ref
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import tabular as jtab


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under the test runner's worker processes the CPU
    forwards lose most of their time to contended threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SLOTS, POP, CUTOFF, COUNT, SEED = 8, 16, 20, 2_000_000, 0


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a round key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


class _InjectedTrainer(tes.ESTrainer):
    """The port's trainer, drawing each round from a given list and the
    eval episodes' seed as given."""

    def __init__(self, *a, rounds, eval_seed=None, **kw):
        super().__init__(*a, **kw)
        self._rounds = list(rounds)
        self._eval_seed = eval_seed

    def _draw_round(self, npairs):
        idxs, seed = self._rounds.pop(0)
        assert idxs.shape == (npairs,)
        return torch.from_numpy(idxs), seed

    def _draw_eval_seed(self):
        return self._eval_seed


@pytest.fixture
def quiet_loggers(monkeypatch):
    """Both packages' tabular rows, kept instead of printed."""
    rows = {"jax": [], "torch": []}

    def keep(mod, name):
        def dump():
            rows[name].append(dict(mod._logger._kvs))
            mod._logger._kvs.clear()

        return dump

    monkeypatch.setattr(jtab, "dump_tabular", keep(jtab, "jax"))
    monkeypatch.setattr(ttab, "dump_tabular", keep(ttab, "torch"))
    return rows


EVAL_METRICS = ("EvalEpRewMean", "EvalEpRewMedian", "EvalEpRewStd", "EvalEpLenMean", "EvalPopRank", "EvalEpCount")


def test_one_generation_matches_jax(quiet_loggers):
    """Returns and lengths equal; the 8 noiseless eval episodes' returns,
    lengths and every Eval* metric equal; g within 1e-5 of max|g|; θ'
    within 1e-6 except near Adam's input G = 0 (see below), where a
    rounding-level change of g moves the first step."""
    # ---------------------------------------------------------- JAX side
    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2)
    jm = JaxVBN(num_actions=jenv.num_actions)
    jcfg = jes.ESConfig(population_size=POP, episode_cutoff_mode=CUTOFF, num_eval_episodes=8)
    jtr = jes.ESTrainer(jenv, jm, jcfg, optimizer=jopt.Adam(stepsize=0.01),
                        noise_table=JaxNoise.from_seed(count=COUNT), seed=SEED)
    theta0 = np.asarray(jtr.state.theta)
    key = jtr.state.key
    jstats = jtr.train_step()
    jenv.close()
    # the eval key and the rounds the JAX trainer drew (es.py train_step / _host_round)
    key, keval = jax.random.split(key)
    npairs, rounds = SLOTS // 2, []
    for _ in range(POP // SLOTS):
        key, kround = jax.random.split(key)
        idxs = np.array(jax.random.randint(kround, (npairs,), 0, COUNT - jm.num_params + 1, dtype=jnp.int32))
        rounds.append((idxs, _jax_seed(kround)))

    # --------------------------------------------------------- port side
    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2)
    tm = TorchVBN(num_actions=tenv.num_actions)
    ttr = _InjectedTrainer(
        tenv, tm, tes.ESConfig(population_size=POP, episode_cutoff_mode=CUTOFF),
        optimizer=topt.Adam(stepsize=0.01), noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"),
        seed=SEED, device="cpu", rounds=rounds, eval_seed=_jax_seed(keval),
    )
    ttr.theta = weights.from_jax(theta0, device="cpu")
    ttr.ref_batch = weights.from_jax(np.asarray(jtr.ref_batch), device="cpu")
    tstats = ttr.train_step()
    ttr.close()

    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    np.testing.assert_array_equal(tstats.returns, jstats.returns)
    assert ttr.iteration == 1 and ttr.episodes_so_far == POP
    assert tstats.eval_returns.shape == (8,)
    np.testing.assert_array_equal(tstats.eval_lengths, np.asarray(jstats.eval_lengths))
    np.testing.assert_array_equal(tstats.eval_returns, np.asarray(jstats.eval_returns))
    (jrow,), (trow,) = quiet_loggers["jax"], quiet_loggers["torch"]
    for name in EVAL_METRICS:
        assert float(trow[name]) == float(jrow[name]), name
    assert trow["EvalEpCount"] == 8

    # the gradient, both packages' way, from the same returns
    idxs = np.concatenate([r[0] for r in rounds])
    srets = np.zeros_like(jstats.returns)  # centered_rank does not read the sign returns
    jw = jfit.process_returns(jnp.asarray(jstats.returns), jnp.asarray(srets), "centered_rank")
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(idxs), jw[:, 0] - jw[:, 1],
                                             jm.num_params)) / jstats.returns.size
    tw = tfit.process_returns(torch.from_numpy(tstats.returns), torch.from_numpy(srets), "centered_rank")
    tg = noise_gradient(ttr.noise.noise, torch.from_numpy(idxs), (tw[:, 0] - tw[:, 1]).contiguous(),
                        tm.num_params).numpy() / tstats.returns.size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * gmax)

    # Adam's first step is −lr·G/(|G| + ε′), G = −g + l2coeff·θ, ε′ = ε/√(1−β₂):
    # ±lr almost everywhere, but steep near G = 0, where an error δG moves the
    # step by lr·ε′·δG/(|G| + ε′)². θ' is compared where δG up to the gradient
    # tolerance moves it by less than 1e-6; everywhere, the step stays within lr.
    lr, eps_ = 0.01, 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + 0.005 * theta0
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(G) + eps_) ** 2 < 1e-6
    jtheta = np.asarray(jtr.state.theta)
    ttheta = ttr.theta.numpy()
    np.testing.assert_allclose(ttheta[steady], jtheta[steady], rtol=0, atol=1e-6)
    assert np.abs(ttheta - theta0).max() <= lr * (1 + 1e-5)
    print(f"θ' compared on {steady.sum()} of {steady.size} entries")


def test_ref_batch_matches_jax():
    """The random-policy reference batch from the same host seed: the same
    frames, so within the resize's 1e-6."""
    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2)
    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2)
    kref = jax.random.PRNGKey(3)
    j = np.asarray(jax_collect_ref(jenv, kref, batch_size=20))
    t = collect_ref_batch_host(tenv, _jax_seed(kref), torch.device("cpu"), batch_size=20)
    jenv.close()
    tenv.close()
    assert t.shape == (20, 84, 84, 4)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("groups", [2, 4])
def test_pipeline_groups_do_not_change_results(groups):
    """Per-slot results do not depend on the slot-group count."""
    env = TorchAtari("toy", batch_size=8, num_threads=2)
    model = TorchVBN(num_actions=env.num_actions)
    gen = torch.Generator().manual_seed(0)
    thetas = torch.stack([model.init_theta(gen) for _ in range(8)])
    ref = torch.rand(8, 84, 84, 4, generator=gen)
    params = (thetas, model.batch_ref_stats(thetas, ref))
    res = [
        rollout_host_batch(env, model.make_batch_act(), params, 11, 25, torch.device("cpu"), pipeline_groups=g)
        for g in (1, groups)
    ]
    env.close()
    np.testing.assert_array_equal(res[0].lengths, res[1].lengths)
    np.testing.assert_array_equal(res[0].returns, res[1].returns)


def test_population_smaller_than_the_slots(quiet_loggers):
    """A round with fewer members than engine slots fills the spare slots
    with copies of its last member and returns only its own pairs."""
    env = TorchAtari("toy", batch_size=8, num_threads=2)
    tr = tes.ESTrainer(env, TorchVBN(num_actions=env.num_actions),
                       tes.ESConfig(population_size=4, episode_cutoff_mode=5),
                       noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), device="cpu")
    stats = tr.train_step()
    tr.close()
    assert stats.returns.shape == (2, 2) and tr.episodes_so_far == 4
    assert bool(torch.isfinite(tr.theta).all())


def test_cutoff_dsl_matches_jax():
    for mode in (200, "adaptive:100,0.5,2,1000", "env_default"):
        assert tuple(tes.parse_cutoff(mode, 400_000)) == tuple(jes.parse_cutoff(mode, 400_000))
    c = tes.parse_cutoff("adaptive:100,0.5,2,150", 0)
    lengths = np.array([100, 100, 3, 100])
    assert tes.update_cutoff(c, lengths).tslimit == jes.update_cutoff(jes.parse_cutoff("adaptive:100,0.5,2,150", 0), lengths).tslimit == 150


@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_generation_through_a_fused_route(quiet_loggers, impl):
    """A tiny generation at full width with forward_impl='fused1' (K4) or
    'fused' (K6), on the CPU's plain versions: finite returns and θ', and
    eight eval episodes through the same route."""
    env = TorchAtari("toy", batch_size=8, num_threads=2)
    tr = tes.ESTrainer(env, TorchVBN(num_actions=env.num_actions, forward_impl=impl),
                       tes.ESConfig(population_size=8, episode_cutoff_mode=4),
                       noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), device="cpu")
    stats = tr.train_step()
    tr.close()
    assert stats.returns.shape == (4, 2) and np.isfinite(stats.returns).all()
    assert np.isfinite(stats.eval_returns).all() and bool(torch.isfinite(tr.theta).all())
    (row,) = quiet_loggers["torch"]
    assert row["EvalEpCount"] == 8 and np.isfinite(row["EvalPopRank"])
