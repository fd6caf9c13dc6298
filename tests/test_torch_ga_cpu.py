"""The GA's CPU-style genomes in the port against the JAX package, on the CPU:
``frostbite_ga.json`` through the loader, ``reinit_theta`` per model, CPU
chains site by site, and two host-engine generations from the JAX draws.

Tolerances, fixed before the comparison:

* ``reinit_theta`` scales each weight column by std/‖column‖, a float32
  sum: rtol 1e-6 (8 ulp; measured up to 3.6e-7), zeros exactly where the
  JAX package's are. A chain built on a re-init keeps that error, relative
  to the re-init's values, while σ·ε moves some entries near 0: within
  1e-6·max|θ| (``_chain_close``).
* Each rounding site of the JAX package is matched bit for bit where the
  inputs are equal: its jitted mutation steps (``_mutate_thetas``,
  ``_tail_reconstruct``) round θ + σ·ε once (an FMA), its eager
  ``_reconstruct`` and ``theta_from_seed_chain`` round σ·ε and the sum
  one after the other. The two disagree by an ulp here and there; the JAX
  package's own test holds lookup against reconstruction to atol 1e-6
  (tests/test_ga.py), and so does this file.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.ops import genome as tgenome
from deep_neuroevolution_torch.ops import noise as tnoise
from deep_neuroevolution_torch.utils import checkpoint as tckpt
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import ga as jga
from deep_neuroevolution_tpu.algos import rollout_host as jroll
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.ops import noise as jnoise
from deep_neuroevolution_tpu.utils import checkpoint as jckpt
from deep_neuroevolution_tpu.utils import config as jconfig
from deep_neuroevolution_tpu.utils import tabular as jtab

ROOT = Path(__file__).resolve().parent.parent
COUNT, SIGMA = 2_000_000, 0.005
REINIT_RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """Intra-op threads only slow small CPU forwards when several test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tables():
    return (jnoise.NoiseTable.from_seed(count=COUNT),
            tnoise.NoiseTable.from_seed(count=COUNT, device="cpu"))


def _frostbite_ga():
    return json.loads((ROOT / "configurations" / "frostbite_ga.json").read_text())


def _reinit_close(t: np.ndarray, j: np.ndarray) -> None:
    np.testing.assert_array_equal(t == 0, j == 0)
    np.testing.assert_allclose(t, j, rtol=REINIT_RTOL, atol=0)


def _chain_close(t: np.ndarray, j: np.ndarray) -> None:
    np.testing.assert_allclose(t, j, rtol=0, atol=REINIT_RTOL * np.abs(j).max())


# ------------------------------------------------------------------ loader


@pytest.mark.parametrize("algo", [None, "ga", "rs"])
def test_frostbite_ga_loads_as_in_jax(algo):
    """Without ``algo`` an ES trainer on SmallDQN (relu), as the JAX loader
    gives; with "ga" or "rs" the CPU-stack GA branch: CPU-style genomes,
    noise_stdev 0.005 as the mutation power, population 10, one elite, no
    validation or test episodes; every GAConfig field equal to the JAX
    loader's. Frostbite runs on ToyCatch with EpisodicLife on 256 slots."""
    over = {"noise_size": COUNT}
    jtr = jconfig.load_experiment(_frostbite_ga(), algo=algo, overrides=over)
    jtr.env.close()
    ttr = tconfig.load_experiment(_frostbite_ga(), algo=algo, overrides=over, device="cpu")
    ttr.close()
    assert type(ttr).__name__ == type(jtr).__name__ == {None: "ESTrainer", "ga": "GATrainer", "rs": "RSTrainer"}[algo]
    assert type(ttr.model).__name__ == type(jtr.model).__name__ == "SmallDQN"
    assert ttr.model.nonlin_type == jtr.model.nonlin_type == "relu"
    assert ttr.model.num_params == jtr.model.num_params and ttr.model.out_std == jtr.model.out_std
    assert (ttr.env.batch_size, ttr.env.episodic_life) == (jtr.env.batch_size, jtr.env.episodic_life) == (256, True)
    if algo is None:
        assert isinstance(ttr, tes.ESTrainer)
        return
    assert ttr.config.__dict__ == jtr.config.__dict__
    assert ttr.config.genome_style == "cpu" and ttr.config.noise_stdev == ttr.config.mutation_power == SIGMA
    assert ttr.config.population_size == 10 and ttr.config.validation_threshold == 0


@pytest.mark.parametrize("bad", [{"nonlin_type": "tanh"}, {"nonlin_type": "elu"}, {"ac_init_std": 0.2}])
def test_unported_policy_args_are_refused(bad):
    """A DQN's nonlin_type other than relu and an ac_init_std other than the
    model's out std reach the model as in the JAX package (its nonlin_type
    and out_std, the same θ size); only a nonlinearity that neither package
    has is refused, when the model is built."""
    exp = _frostbite_ga()
    exp["policy"]["args"].update(bad)
    jtr = jconfig.load_experiment(exp, overrides={"noise_size": COUNT})
    jtr.env.close()
    assert jtr.model.nonlin_type != "relu" or jtr.model.out_std != 0.1
    ttr = tconfig.load_experiment(exp, overrides={"noise_size": COUNT}, device="cpu")
    ttr.close()
    assert (ttr.model.nonlin_type, ttr.model.out_std) == (jtr.model.nonlin_type, jtr.model.out_std)
    assert ttr.model.num_params == jtr.model.num_params
    with pytest.raises(ValueError, match="nonlin_type"):
        tmodels.VirtualBNDQN(num_actions=4, nonlin_type="swish")


def test_the_models_own_out_std_is_accepted():
    exp = _frostbite_ga()
    exp["policy"]["args"]["ac_init_std"] = 0.1
    tr = tconfig.load_experiment(exp, algo="ga", overrides={"noise_size": COUNT}, device="cpu")
    tr.close()
    assert isinstance(tr, tga.GATrainer)


def test_eval_batch_override_reaches_the_ga():
    """The GA's eval_batch override (the device arm's round size), on a
    GPU-stack and a CPU-stack file, as the JAX loader passes it; NS-ES
    refuses it."""
    for name, algo in (("es_gym_config.json", "ga"), ("maze_es.json", "rs")):
        exp = json.loads((ROOT / "configurations" / name).read_text())
        over = {"noise_size": COUNT, "eval_batch": 7}
        jtr = jconfig.load_experiment(exp, algo=algo, overrides=over)
        ttr = tconfig.load_experiment(exp, algo=algo, overrides=over, device="cpu")
        assert ttr.config.eval_batch == jtr.config.eval_batch == 7
        assert ttr.config.__dict__ == jtr.config.__dict__
    exp = json.loads((ROOT / "configurations" / "maze_nses.json").read_text())
    with pytest.raises(ValueError, match="eval_batch"):
        tconfig.load_experiment(exp, overrides={"noise_size": COUNT, "eval_batch": 7}, device="cpu")


# ------------------------------------------------------------ reinit_theta


REINIT_CASES = {
    "SmallDQN": (jmodels.SmallDQN, tmodels.SmallDQN, dict(num_actions=4)),
    "LargeDQN": (jmodels.LargeDQN, tmodels.LargeDQN, dict(num_actions=4)),
    "VirtualBNDQN": (JaxVBN, tmodels.VirtualBNDQN, dict(num_actions=4)),
    "VirtualBNDQN-full": (JaxVBN, tmodels.VirtualBNDQN, dict(num_actions=4, affine="full")),
    "LinearClassifier": (jmodels.LinearClassifier, tmodels.LinearClassifier, dict(obs_dim=4, num_actions=2)),
    "SimpleClassifier": (jmodels.SimpleClassifier, tmodels.SimpleClassifier, dict(obs_dim=4, num_actions=2)),
    "ContinuousMLP": (jmodels.ContinuousMLP, tmodels.ContinuousMLP, dict(obs_dim=11, ac_dim=2)),
    "MujocoMLP": (jmodels.MujocoMLP, tmodels.MujocoMLP,
                  dict(obs_dim=11, ac_dim=2, ac_low=(-1.0, -1.0), ac_high=(1.0, 1.0))),
}


@pytest.mark.parametrize("case", sorted(REINIT_CASES))
def test_reinit_theta_matches_jax(case):
    """Two raw rows through the JAX package's vmapped re-init (as its
    trainers call it) and the port's batched one; each weight column of the
    port's result has L2 norm std within 1e-6, each bias is zero."""
    jcls, tcls, kw = REINIT_CASES[case]
    jm, tm = jcls(**kw), tcls(**kw)
    assert jm.num_params == tm.num_params
    x = np.random.RandomState(0).randn(2, tm.num_params).astype(np.float32)
    j = np.asarray(jax.vmap(jm.reinit_theta)(jnp.asarray(x)))
    t = tm.reinit_theta(torch.from_numpy(x))
    _reinit_close(t.numpy(), j)
    np.testing.assert_array_equal(tm.reinit_theta(torch.from_numpy(x[1])).numpy(), t[1].numpy())
    for spec, part in zip(tm.specs, tm.unflatten(t).values()):
        if spec.init == "normc":
            norms = part.reshape(2, -1, spec.shape[-1]).double().norm(dim=1)
            np.testing.assert_allclose(norms.numpy(), spec.std, rtol=1e-6)
        else:
            assert not part.any()


# -------------------------------------------------------------- CPU chains


def _trainers(tables):
    """A JAX and a port GATrainer with CPU-style genomes on a 4-slot engine,
    the same parent cache in both: (a,) and (b, c), from the JAX package's
    reconstruction."""
    jt, tt = tables
    cfg = dict(population_size=4, genome_style="cpu", noise_stdev=SIGMA)
    jenv, tenv = JaxAtari("toy", batch_size=4, num_threads=1), TorchAtari("toy", batch_size=4, num_threads=1)
    jtr = jga.GATrainer(jenv, jmodels.SmallDQN(num_actions=jenv.num_actions), jga.GAConfig(**cfg), noise_table=jt)
    ttr = tga.GATrainer(tenv, tmodels.SmallDQN(num_actions=tenv.num_actions), tga.GAConfig(**cfg), noise_table=tt,
                        device="cpu")
    jenv.close()
    ttr.close()
    parents = [(101,), (2024, 77_777)]
    cached = np.stack([np.asarray(jtr._reconstruct(p)) for p in parents])
    jtr.cached_parent_seeds, jtr.cached_parent_thetas = list(parents), jnp.asarray(cached)
    ttr.cached_parent_seeds, ttr.cached_parent_thetas = list(parents), torch.from_numpy(cached.copy())
    return jtr, ttr


def _jax_reinit(jtr):
    """The JAX package's re-init, as a function of a port tensor."""
    return lambda row: torch.from_numpy(np.array(jtr.model.reinit_theta(jnp.asarray(row.numpy()))))


def test_cpu_chains_match_jax_site_by_site(tables):
    """``_lookup_theta`` of each kind of chain against the JAX package's:
    a cached parent and a cached prefix plus a bare index (one rounding a
    step, the JAX jitted ``_tail_reconstruct``) bit for bit; a chain that
    misses the cache (``_reconstruct``'s re-init, then two roundings a
    step) as ``_chain_close`` says, and bit for bit once the port is given
    the JAX package's re-init; ``theta_from_seed_chain(..., 'cpu')`` the
    same way."""
    jtr, ttr = _trainers(tables)
    jt, tt = tables
    D = ttr.model.num_params
    look = lambda tr, s: np.asarray(tr._lookup_theta(s))  # noqa: E731
    np.testing.assert_array_equal(look(ttr, (2024, 77_777)), look(jtr, (2024, 77_777)))
    np.testing.assert_array_equal(look(ttr, (2024, 77_777, 31_337)), look(jtr, (2024, 77_777, 31_337)))
    np.testing.assert_array_equal(look(ttr, (101, 5)), look(jtr, (101, 5)))
    miss = (999, 123_456, 42, 1_000_000)
    jfull = look(jtr, miss)
    _reinit_close(look(ttr, (999,)), look(jtr, (999,)))
    _chain_close(look(ttr, miss), jfull)
    exact = tgenome.reconstruct_cpu_style(tt.noise, miss, D, _jax_reinit(jtr), SIGMA).numpy()
    np.testing.assert_array_equal(exact, jfull)
    jchain = np.asarray(jckpt.theta_from_seed_chain(jtr.model, jt, list(miss), genome_style="cpu", noise_stdev=SIGMA))
    np.testing.assert_array_equal(jchain, jfull)
    tchain = tckpt.theta_from_seed_chain(ttr.model, tt, list(miss), genome_style="cpu", noise_stdev=SIGMA).numpy()
    np.testing.assert_array_equal(tchain, look(ttr, miss))


def test_lookup_against_reconstruction_as_in_jax(tables):
    """The JAX package's own gap, in both packages: a chain through the
    cache (one rounding a step) against the same chain rebuilt whole (two
    roundings a step) differs by an ulp on some entries and by at most
    1e-6 (the JAX package's tests/test_ga.py bound); given the JAX
    package's re-init, the port's gap is the JAX package's entry for
    entry."""
    jtr, ttr = _trainers(tables)
    chain = (2024, 77_777, 31_337)
    jgap = np.asarray(jtr._lookup_theta(chain)) - np.asarray(jtr._reconstruct(chain))
    cached = ttr._lookup_theta(chain).numpy()
    whole = tgenome.reconstruct_cpu_style(tables[1].noise, chain, ttr.model.num_params, _jax_reinit(jtr), SIGMA)
    np.testing.assert_array_equal(cached - whole.numpy(), jgap)
    assert 0 < np.abs(jgap).max() <= 1e-6
    ttr.cached_parent_seeds, ttr.cached_parent_thetas = [], None
    assert np.abs(cached - ttr._lookup_theta(chain).numpy()).max() <= 1e-6
    print(f"lookup - reconstruct: max {np.abs(jgap).max():.3g} on {(jgap != 0).sum()} of {jgap.size} entries")


# ---------------------------------------------- host-engine generations


class _Injected(tga.GATrainer):
    """The port's GA drawing offspring and rollout seeds from lists."""

    def __init__(self, *a, offspring, seeds, **kw):
        self._offspring, self._seeds = list(offspring), list(seeds)
        super().__init__(*a, **kw)

    def _draw_offspring(self, n, n_parents):
        pidx, midx = self._offspring.pop(0)
        assert pidx.shape == midx.shape == (n,)
        return pidx, midx

    def _draw_seed(self):
        return self._seeds.pop(0)


def _jax_seed(key) -> int:
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


def test_two_cpu_style_generations_on_the_engine_match_jax(monkeypatch, tables):
    """frostbite_ga.json's GA at a small size (SmallDQN, 8 slots with
    EpisodicLife, population 10 in rounds of 8, one elite, cutoff 20,
    σ = 0.005): two generations from the JAX draws; the chains (bare
    indices), fitness, lengths and tabular rows equal, the cached parents'
    θ as a chain on a re-init (``_chain_close``)."""
    jt, tt = tables
    offspring, seeds = [], []
    real_mut, real_rand, real_roll = jga._mutate_thetas, jga._randomize_thetas, jroll.rollout_host

    def mut(*a, **k):
        out = real_mut(*a, **k)
        offspring.append((np.asarray(out[0]).astype(np.int64), np.asarray(out[1]).astype(np.int64)))
        return out

    def rand(table, key, n, dim, scale_by):
        out = real_rand(table, key, n, dim, scale_by)
        offspring.append((np.zeros(n, np.int64), np.asarray(out[0]).astype(np.int64)))
        return out

    def roll(henv, act_fn, params, key, *a, **k):
        seeds.append(_jax_seed(key))
        return real_roll(henv, act_fn, params, key, *a, **k)

    rows = {"jax": [], "torch": []}

    def keep(mod, name):
        def dump():
            rows[name].append(dict(mod._logger._kvs))
            mod._logger._kvs.clear()
        return dump

    monkeypatch.setattr(jga, "_mutate_thetas", mut)
    monkeypatch.setattr(jga, "_randomize_thetas", rand)
    monkeypatch.setattr(jroll, "rollout_host", roll)
    monkeypatch.setattr(jtab, "dump_tabular", keep(jtab, "jax"))
    monkeypatch.setattr(ttab, "dump_tabular", keep(ttab, "torch"))
    cfg = dict(population_size=10, num_elites=1, selection_threshold=20, mutation_power=SIGMA, noise_stdev=SIGMA,
               genome_style="cpu", episode_cutoff_mode=20, validation_threshold=0, num_validation_episodes=0,
               num_test_episodes=0)
    jenv = JaxAtari("toy", batch_size=8, num_threads=2, episodic_life=True)
    jtr = jga.GATrainer(jenv, jmodels.SmallDQN(num_actions=jenv.num_actions), jga.GAConfig(**cfg), noise_table=jt)
    jtr.train(2)
    jenv.close()
    tenv = TorchAtari("toy", batch_size=8, num_threads=2, episodic_life=True)
    ttr = _Injected(tenv, tmodels.SmallDQN(num_actions=tenv.num_actions), tga.GAConfig(**cfg), noise_table=tt,
                    device="cpu", offspring=offspring, seeds=seeds)
    ttr.train(2)
    ttr.close()
    assert not ttr._offspring and not ttr._seeds
    js, ts = jtr.state, ttr.state
    assert [o.seeds for o in ts.population] == [o.seeds for o in js.population]
    assert all(isinstance(i, int) for o in ts.population for i in o.seeds)
    assert max(len(o.seeds) for o in ts.population) == 2
    assert [(o.fitness, o.training_steps) for o in ts.population] == [(o.fitness, o.training_steps)
                                                                       for o in js.population]
    assert ttr.cached_parent_seeds == jtr.cached_parent_seeds
    _chain_close(ttr.cached_parent_thetas.numpy(), np.asarray(jtr.cached_parent_thetas))
    clocks = {"TimestepsPerSecondThisIter", "TimeElapsedThisIter", "TimeElapsed"}
    assert len(rows["torch"]) == len(rows["jax"]) == 2
    for j, t in zip(rows["jax"], rows["torch"]):
        assert list(t) == list(j)
        assert all(float(t[k]) == float(j[k]) for k in j if k not in clocks)
