"""The GA's and RS's device arm in the port against the JAX package's, on
CartPole with a LinearClassifier, on the CPU, for both genome styles.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX trainer drew: each fitness round's parent and noise indices and
its members' reset states (derived from the keys ``_ga_gen_rounds`` was
given, the way it splits them), and the reset states of each ladder round
(``_eval_thetas``'s keys). CartPole's returns are its lengths and the
LinearClassifier's action an argmax, so fitness, lengths, the chains, the
elite and the tabular rows must be equal. Episodes are cut at 60 steps,
the elite's test episodes too (the env's default cutoff, 500 in
CartPole-v1): the two packages' float32 physics and forwards round in
another order (tests/test_torch_rollout.py holds them equal to 50 steps),
and one test episode of 132 steps here ended a step later in the port.
The cached parents' θ: bit for bit for GPU-style chains (the mutation is
one rounding in both packages), within 1e-6·max|θ| for CPU-style ones
(their re-init is a float32 sum in another order,
tests/test_torch_ga_cpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import NoCudaDevice
from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.ops import noise as tnoise
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import ga as jga
from deep_neuroevolution_tpu.ops import noise as jnoise
from deep_neuroevolution_tpu.utils import tabular as jtab

COUNT, CUTOFF = 200_000, 60
CLOCKS = {"TimestepsPerSecondThisIter", "TimeElapsedThisIter", "TimeElapsed"}


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(pkg, style):
    """Population 12 in rounds of eval_batch = 5 (three rounds, the last
    one's 3 surplus members dropped); a ladder of 3 × 2 validation episodes
    (rounds of 5 and 1) and 3 test episodes."""
    return pkg.GAConfig(population_size=12, eval_batch=5, selection_threshold=4, validation_threshold=3,
                        num_validation_episodes=2, num_test_episodes=3, mutation_power=0.1, noise_stdev=0.1,
                        genome_style=style, episode_cutoff_mode=CUTOFF)


class _Injected:
    """The port's trainer drawing offspring and reset states from lists;
    records each device round's size."""

    def __init__(self, *a, offspring, starts, **kw):
        self._offspring, self._starts, self.rounds = list(offspring), list(starts), []
        super().__init__(*a, **kw)

    def _draw_offspring(self, n, n_parents):
        pidx, midx = self._offspring.pop(0)
        assert pidx.shape == midx.shape == (n,) and (n_parents == 0 or pidx.max() < n_parents)
        return pidx, midx

    def _episode_starts(self, seed, n):
        state = self._starts.pop(0)
        assert state[0].shape[0] == n
        self.rounds.append(n)
        return state


class InjectedGA(_Injected, tga.GATrainer):
    pass


class InjectedRS(_Injected, tga.RSTrainer):
    pass


def _run_both(monkeypatch, style: str, rs: bool, generations: int):
    """``generations`` of the JAX trainer, recording its draws, then of the
    port's from them; returns (jax trainer, port trainer, jax rows, port
    rows, the JAX rounds' sizes)."""
    jenv, tenv = (pkg.make("gym.CartPole-v1", default_timestep_cutoff=CUTOFF) for pkg in (jenvs, tenvs))
    state_cls = type(tenv.reset(1, torch.Generator(), torch.device("cpu")))

    def to_torch(keys):
        return state_cls(*(torch.from_numpy(np.array(f)) for f in jax.vmap(jenv.reset)(keys)))

    offspring, starts, sizes = [], [], []
    real_rounds, real_eval = jga._ga_gen_rounds, jga._eval_thetas

    def gen_rounds(env, model, parents, table, chunk, n_rounds, randomize, cpu_init, key, *rest):
        size = table.shape[0] - model.num_params + 1
        for rkey in jax.random.split(key, n_rounds):  # the body's own splits
            kp, km, kroll = jax.random.split(rkey, 3)
            midx = np.asarray(jax.random.randint(km, (chunk,), 0, size, dtype=jnp.int32)).astype(np.int64)
            pidx = (np.zeros(chunk, np.int64) if randomize else
                    np.asarray(jax.random.randint(kp, (chunk,), 0, parents.shape[0], dtype=jnp.int32)).astype(np.int64))
            offspring.append((pidx, midx))
            starts.append(to_torch(jax.random.split(kroll, chunk)))
            sizes.append(chunk)
        return real_rounds(env, model, parents, table, chunk, n_rounds, randomize, cpu_init, key, *rest)

    def eval_thetas(env, model, thetas, keys, *rest):
        starts.append(to_torch(keys))
        sizes.append(int(keys.shape[0]))
        return real_eval(env, model, thetas, keys, *rest)

    rows = {"jax": [], "torch": []}

    def keep(mod, name):
        def dump():
            rows[name].append(dict(mod._logger._kvs))
            mod._logger._kvs.clear()
        return dump

    monkeypatch.setattr(jga, "_ga_gen_rounds", gen_rounds)
    monkeypatch.setattr(jga, "_eval_thetas", eval_thetas)
    monkeypatch.setattr(jtab, "dump_tabular", keep(jtab, "jax"))
    monkeypatch.setattr(ttab, "dump_tabular", keep(ttab, "torch"))
    kw = dict(obs_dim=4, num_actions=2)
    jctor = jga.RSTrainer if rs else jga.GATrainer
    jtr = jctor(jenv, jmodels.LinearClassifier(**kw), _cfg(jga, style),
                noise_table=jnoise.NoiseTable.from_seed(count=COUNT))
    jtr.train(generations)
    tctor = InjectedRS if rs else InjectedGA
    ttr = tctor(tenv, tmodels.LinearClassifier(**kw), _cfg(tga, style),
                noise_table=tnoise.NoiseTable.from_seed(count=COUNT, device="cpu"), device="cpu",
                offspring=offspring, starts=starts)
    ttr.train(generations)
    assert not ttr._offspring and not ttr._starts, "the port drew fewer rounds than the JAX trainer"
    return jtr, ttr, rows, sizes


def _assert_same(jtr, ttr, rows):
    js, ts = jtr.state, ttr.state
    assert [o.seeds for o in ts.population] == [o.seeds for o in js.population]
    assert [(o.fitness, o.training_steps) for o in ts.population] == [(o.fitness, o.training_steps)
                                                                       for o in js.population]
    assert ts.elite.seeds == js.elite.seeds and ts.curr_solution == js.curr_solution
    assert (ts.curr_solution_val, ts.curr_solution_test) == (js.curr_solution_val, js.curr_solution_test)
    assert (ts.it, ts.timesteps_so_far, ts.validation_timesteps_so_far) == (
        js.it, js.timesteps_so_far, js.validation_timesteps_so_far)
    assert len(rows["torch"]) == len(rows["jax"]) == ts.it
    for j, t in zip(rows["jax"], rows["torch"]):
        assert list(t) == list(j)
        assert all(float(t[k]) == float(j[k]) for k in j if k not in CLOCKS), (j, t)


@pytest.mark.parametrize("style", ["gpu", "cpu"])
def test_two_ga_generations_on_the_device_arm(monkeypatch, style):
    """Two generations: the first draws fresh genomes (ε·scale_by, or the
    re-init), the second mutates the cached parents; each fitness pass runs
    three rounds of 5, the ladder rounds of 5, 1 and 3."""
    jtr, ttr, rows, sizes = _run_both(monkeypatch, style, rs=False, generations=2)
    _assert_same(jtr, ttr, rows)
    assert ttr.rounds == sizes == [5, 5, 5, 5, 1, 3] * 2
    lens = {len(o.seeds) for o in ttr.state.population}
    assert 2 in lens and lens <= {1, 2}
    tail = next(o.seeds[1] for o in ttr.state.population if len(o.seeds) == 2)
    assert isinstance(tail, tuple) if style == "gpu" else isinstance(tail, int)
    assert ttr.cached_parent_seeds == jtr.cached_parent_seeds
    t, j = ttr.cached_parent_thetas.numpy(), np.asarray(jtr.cached_parent_thetas)
    if style == "gpu":
        np.testing.assert_array_equal(t, j)
    else:
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-6 * np.abs(j).max())


@pytest.mark.parametrize("style", ["gpu", "cpu"])
def test_one_rs_generation_on_the_device_arm(monkeypatch, style):
    """Random search: fresh genomes in three rounds of 5, the ladder, and
    the best candidate kept, as in the JAX package."""
    jtr, ttr, rows, sizes = _run_both(monkeypatch, style, rs=True, generations=1)
    _assert_same(jtr, ttr, rows)
    assert ttr.rounds == sizes == [5, 5, 5, 5, 1, 3]
    assert ttr.cached_parent_thetas is None and all(len(o.seeds) == 1 for o in ttr.state.population)
    assert (ttr.best_score, ttr.best_seeds) == (jtr.best_score, jtr.best_seeds)


def test_device_arm_without_eval_batch_runs_one_round(monkeypatch):
    """eval_batch 0: the whole population in one round, the θ budget's cap
    aside (budget // (4·D) members a round)."""
    env, model = tenvs.make("gym.CartPole-v1"), tmodels.LinearClassifier(obs_dim=4, num_actions=2)
    table = tnoise.NoiseTable.from_seed(count=COUNT, device="cpu")
    for budget, want in ((2**31, 12), (4 * 4 * model.num_params, 4)):
        cfg = tga.GAConfig(population_size=12, selection_threshold=2, validation_threshold=0, episode_cutoff_mode=20,
                           theta_hbm_budget=budget)
        tr = tga.GATrainer(env, model, cfg, noise_table=table, device="cpu")
        assert tr._chunk(12) == want
        seen = []
        real = tr._eval_device
        tr._eval_device = lambda th, ts: seen.append(th.shape[0]) or real(th, ts)
        monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
        tr.train_step()
        assert seen == [want] * (12 // want) and len(tr.state.population) == 12


def test_device_arm_needs_a_card_unless_asked_for_the_cpu():
    """Without ``device="cpu"`` the GA and RS run on CUDA, and without a
    card they stop with NoCudaDevice, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env, model = tenvs.make("gym.CartPole-v1"), tmodels.LinearClassifier(obs_dim=4, num_actions=2)
    table = tnoise.NoiseTable.from_seed(count=COUNT, device="cpu")
    for ctor in (tga.GATrainer, tga.RSTrainer):
        with pytest.raises(NoCudaDevice):
            ctor(env, model, tga.GAConfig(population_size=4), noise_table=table)
