"""The port's GA and RS against the JAX package's GATrainer on the ToyCatch
engine, on the CPU, and the genome, schedule and rollout pieces they use.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX trainer drew: each fitness round's parent and noise indices, and
each rollout's seed (from which both packages draw the noop counts and the
engine's episode seeds in the same order)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import main as tmain
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.algos.rollout_host import rollout_host_batch
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.models import dqn as tdqn
from deep_neuroevolution_torch.ops import genome as tgenome
from deep_neuroevolution_torch.ops import noise as tnoise
from deep_neuroevolution_torch.ops import schedules as tsched
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu.algos import ga as jga
from deep_neuroevolution_tpu.algos import rollout_host as jroll
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models import dqn as jdqn
from deep_neuroevolution_tpu.ops import genome as jgenome
from deep_neuroevolution_tpu.ops import noise as jnoise
from deep_neuroevolution_tpu.ops import schedules as jsched
from deep_neuroevolution_tpu.utils import tabular as jtab

ROOT = Path(__file__).resolve().parent.parent
SLOTS, POP, CUTOFF, COUNT, SEED = 8, 16, 20, 2_000_000, 0
# timing metrics differ between any two runs; every other tabular value must match
_CLOCKS = {"TimestepsPerSecondThisIter", "TimeElapsedThisIter", "TimeElapsed"}


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a rollout key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as in tests/test_torch_checkpoint.py: under
    several test workers, CPU forwards lose most of their time to threads
    waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables():
    return (jnoise.NoiseTable.from_seed(count=COUNT),
            tnoise.NoiseTable.from_seed(count=COUNT, device="cpu"))


# ------------------------------------------------------------------ pieces


class TestSchedules:
    @pytest.mark.parametrize("spec", [
        0.002,
        {"type": "ConstantSchedule", "value": 0.005},
        {"type": "LinearSchedule", "schedule": 1e6, "final_p": 0.0005, "initial_p": 0.005, "field": "frames"},
    ])
    def test_equal_values(self, spec):
        """Constant and linear: the same float32 values bit for bit."""
        j, t = jsched.make_schedule(spec), tsched.make_schedule(spec)
        for frames in (0, 1, 123_457, 999_999, 1_000_000, 5_000_000):
            assert np.float32(t.value(frames=frames, iteration=0)) == np.float32(
                np.asarray(j.value(frames=frames, iteration=0)))

    def test_exponential(self):
        """Exponential: float32 log and exp may differ by an ulp between XLA's
        and numpy's implementations, so within 2 ulp (rtol 2.4e-7)."""
        spec = {"type": "ExponentialSchedule", "initial_p": 0.01, "final_p": 0.0001, "schedule": 1e6, "field": "frames"}
        j, t = jsched.make_schedule(spec), tsched.make_schedule(spec)
        for frames in (0, 250_000, 777_777, 2_000_000):
            np.testing.assert_allclose(t.value(frames=frames), np.asarray(j.value(frames=frames)), rtol=2.4e-7)


class TestGenomes:
    def test_pad_chains(self):
        chains = [(5,), (7, (11, 0.002)), (3, (4, 0.5), (9, 0.25))]
        ji, jp = jgenome.pad_chains(chains, 4)
        ti, tp = tgenome.pad_chains(chains, 4)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        with pytest.raises(ValueError):
            tgenome.pad_chains(chains, 2)

    def test_reconstruct_bit_exact(self, tables):
        """θ from padded chains over the same table: bit for bit, single and
        batched, with and without scale_by, the JAX package's mutation steps
        being fused multiply-adds under jit; ``extend`` against the jitted
        JAX ``extend`` (the way its trainers run their steps); noise_rows too
        (an offset past the last valid start clamps, as lax.dynamic_slice
        does)."""
        jt, tt = tables
        m = jdqn.SmallDQN(num_actions=4)
        D = m.num_params
        sb = np.asarray(m.scale_by("fan_in"))
        chains = [(5,), (123, (999_999, np.float32(0.002)), (77, np.float32(0.0013))), (COUNT - D, (1, np.float32(0.5)))]
        ji, jp = jgenome.pad_chains(chains, 3)
        ti, tp = tgenome.pad_chains(chains, 3)
        jb = np.asarray(jgenome.reconstruct_gpu_style_batch(jt.noise, ji, jp, D, jnp.asarray(sb)))
        tb = tgenome.reconstruct_gpu_style_batch(tt.noise, ti, tp, D, torch.from_numpy(sb.copy())).numpy()
        np.testing.assert_array_equal(tb, jb)
        one = tgenome.reconstruct_gpu_style(tt.noise, ti[1], tp[1], D).numpy()
        np.testing.assert_array_equal(one, np.asarray(jgenome.reconstruct_gpu_style(jt.noise, ji[1], jp[1], D)))
        je = np.asarray(jax.jit(jgenome.extend, static_argnums=4)(
            jnp.asarray(jb[0]), jt.noise, jnp.int32(42), jnp.float32(0.002), D))
        te = tgenome.extend(torch.from_numpy(tb[0]), tt.noise, 42, 0.002, D).numpy()
        np.testing.assert_array_equal(te, je)
        idxs = np.array([0, 17, COUNT - D, COUNT - D + 5], np.int32)
        np.testing.assert_array_equal(tnoise.noise_rows(tt.noise, torch.from_numpy(idxs), 1000).numpy(),
                                      np.asarray(jnoise.noise_rows(jt.noise, jnp.asarray(idxs), 1000)))


class TestNSlots:
    def test_n_slots_equals_a_smaller_engine_and_jax(self):
        """Slots [0, 4) of an 8-slot engine give what a 4-slot engine gives
        from the same seed, and what the JAX package's n_slots run gives:
        returns, lengths and final RAM (the BC) equal."""
        model = tdqn.SmallDQN(num_actions=4)
        sb = model.scale_by().numpy()
        th = torch.from_numpy((np.random.RandomState(0).randn(4, model.num_params) * sb).astype(np.float32))
        key = jax.random.PRNGKey(9)
        seed = _jax_seed(key)
        env8, env4 = TorchAtari("toy", batch_size=8, num_threads=2), TorchAtari("toy", batch_size=4, num_threads=2)
        act = model.make_batch_act()
        sub = rollout_host_batch(env8, act, (th, None), seed, 30, torch.device("cpu"), n_slots=4)
        small = rollout_host_batch(env4, act, (th, None), seed, 30, torch.device("cpu"))
        env8.close()
        env4.close()
        jenv = JaxAtari("toy", batch_size=8, num_threads=2)
        jm = jdqn.SmallDQN(num_actions=4)
        jres = jroll.rollout_host_batch(jenv, jm.make_batch_act(), (jnp.asarray(th.numpy()), None), key, 30,
                                        n_slots=4)
        jenv.close()
        assert sub.bc.shape == (4, 128)
        for a, b in ((sub, small), (sub, jres)):
            np.testing.assert_array_equal(a.returns, np.asarray(b.returns))
            np.testing.assert_array_equal(a.lengths, np.asarray(b.lengths))
            np.testing.assert_array_equal(a.bc, np.asarray(b.bc))


# --------------------------------------------------------------- trainers


def _capture_tabular(module, rows):
    def dump():
        rows.append(dict(module._logger._kvs))
        module._logger._kvs.clear()
    return dump


class _Injected:
    """The port's trainer, drawing offspring and rollout seeds from lists."""

    def __init__(self, *a, offspring, seeds, **kw):
        self._offspring, self._seeds = list(offspring), list(seeds)
        super().__init__(*a, **kw)

    def _draw_offspring(self, n, n_parents):
        pidx, midx = self._offspring.pop(0)
        assert pidx.shape == midx.shape == (n,)
        assert n_parents == 0 or pidx.max() < n_parents
        return pidx, midx

    def _draw_seed(self):
        return self._seeds.pop(0)


class InjectedGA(_Injected, tga.GATrainer):
    pass


class InjectedRS(_Injected, tga.RSTrainer):
    pass


def _ga_cfg(pkg):
    return pkg.GAConfig(population_size=POP, selection_threshold=4, validation_threshold=3,
                        num_validation_episodes=2, num_test_episodes=3, episode_cutoff_mode=CUTOFF)


def _run_both(monkeypatch, tables, rs: bool, generations: int = 2):
    """``generations`` generations in each package from the same draws;
    returns (jax trainer, port trainer, jax rows, port rows)."""
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

    monkeypatch.setattr(jga, "_mutate_thetas", mut)
    monkeypatch.setattr(jga, "_randomize_thetas", rand)
    monkeypatch.setattr(jroll, "rollout_host", roll)
    jrows, trows = [], []
    monkeypatch.setattr(jtab, "dump_tabular", _capture_tabular(jtab, jrows))
    monkeypatch.setattr(ttab, "dump_tabular", _capture_tabular(ttab, trows))

    jenv = JaxAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2)
    jctor = jga.RSTrainer if rs else jga.GATrainer
    jtr = jctor(jenv, jdqn.SmallDQN(num_actions=jenv.num_actions), _ga_cfg(jga), noise_table=jt, seed=SEED)
    jtr.train(generations)
    jenv.close()

    tenv = TorchAtari("toy", batch_size=SLOTS, num_threads=2, pipeline_groups=2)
    tctor = InjectedRS if rs else InjectedGA
    ttr = tctor(tenv, tdqn.SmallDQN(num_actions=tenv.num_actions), _ga_cfg(tga), noise_table=tt, seed=SEED,
                device="cpu", offspring=offspring, seeds=seeds)
    ttr.train(generations)
    ttr.close()
    assert not ttr._offspring and not ttr._seeds, "the port drew fewer times than the JAX trainer"
    return jtr, ttr, jrows, trows


def _assert_same_state(jtr, ttr):
    js, ts = jtr.state, ttr.state
    assert [o.seeds for o in ts.population] == [o.seeds for o in js.population]
    assert [o.fitness for o in ts.population] == [o.fitness for o in js.population]
    assert [o.training_steps for o in ts.population] == [o.training_steps for o in js.population]
    assert ts.elite.seeds == js.elite.seeds and ts.curr_solution == js.curr_solution
    assert (ts.curr_solution_val, ts.curr_solution_test) == (js.curr_solution_val, js.curr_solution_test)
    assert (ts.it, ts.timesteps_so_far, ts.validation_timesteps_so_far) == (
        js.it, js.timesteps_so_far, js.validation_timesteps_so_far)


def _assert_same_rows(jrows, trows):
    assert len(trows) == len(jrows)
    for j, t in zip(jrows, trows):
        assert list(t) == list(j)
        for k in j:
            if k not in _CLOCKS:
                assert float(t[k]) == float(j[k]), (k, t[k], j[k])


def test_two_ga_generations_match_jax(monkeypatch, tables):
    """SmallDQN, 8 slots, population 16 in two rounds, cutoff 20, a small
    validation and test ladder. After each of two generations: the chains,
    fitness and lengths (exact), the elite and the validation means (in the
    tabular row), the parent set, and the tabular keys and values. The
    cached parent θ within f32 rounding (it is the same f32 arithmetic)."""
    jtr, ttr, jrows, trows = _run_both(monkeypatch, tables, rs=False)
    _assert_same_state(jtr, ttr)
    _assert_same_rows(jrows, trows)
    lens = [len(o.seeds) for o in ttr.state.population]
    assert set(lens) <= {1, 2} and lens.count(2) >= POP - 1  # at most the carried-over elite is of length 1
    assert ttr.cached_parent_seeds == jtr.cached_parent_seeds
    jp = np.asarray(jtr.cached_parent_thetas)
    np.testing.assert_allclose(ttr.cached_parent_thetas.numpy(), jp, rtol=0, atol=1e-7 * np.abs(jp).max())


def test_rs_keeps_the_best_ever(monkeypatch, tables):
    """Random search: every generation draws fresh genomes; the best
    candidate ever seen is kept, as in the JAX package."""
    jtr, ttr, jrows, trows = _run_both(monkeypatch, tables, rs=True)
    _assert_same_state(jtr, ttr)
    _assert_same_rows(jrows, trows)
    assert ttr.cached_parent_seeds == [] and ttr.cached_parent_thetas is None
    assert all(len(o.seeds) == 1 for o in ttr.state.population)
    assert (ttr.best_score, ttr.best_seeds) == (jtr.best_score, jtr.best_seeds)
    assert ttr.best_score == max(r["PopulationEpRewMax"] for r in trows)


def test_theta_budget_chunks_the_fitness_pass(monkeypatch):
    """theta_hbm_budget caps a fitness round at budget // (4·D) members;
    each round is padded to a power-of-two slot bucket (ga.py:357-380)."""
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
    env = TorchAtari("toy", batch_size=8, num_threads=2)
    model = tdqn.SmallDQN(num_actions=env.num_actions)
    cfg = tga.GAConfig(population_size=7, selection_threshold=2, validation_threshold=0, episode_cutoff_mode=5,
                       theta_hbm_budget=3 * 4 * model.num_params)
    tr = tga.GATrainer(env, model, cfg, noise_table=tnoise.NoiseTable.from_seed(count=COUNT, device="cpu"),
                       device="cpu")
    calls = []
    real = tr._eval_host
    monkeypatch.setattr(tr, "_eval_host", lambda th, ts: calls.append(th.shape[0]) or real(th, ts))
    tr.train_step()
    tr.close()
    assert calls == [3, 3, 3]  # three rounds of 3; the last one's surplus is dropped
    assert len(tr.state.population) == 7 and tr.cached_parent_thetas.shape == (2, model.num_params)


def test_cli_ga_on_cpu(tmp_path, monkeypatch):
    """``main train --algo ga --device cpu`` on a GPU-schema file at a tiny
    size: two generations; every chain of the second is of length 2 but at
    most the elite carried over from the first."""
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
    exp = json.loads((ROOT / "configurations" / "ga_atari_config.json").read_text())
    exp.update(model="Model", validation_threshold=2, num_validation_episodes=1, num_test_episodes=1)
    path = tmp_path / "ga.json"
    path.write_text(json.dumps(exp))
    args = tmain.build_parser().parse_args([
        "train", "--algo", "ga", "--device", "cpu", "--exp_file", str(path), "--iterations", "2",
        "--overrides", json.dumps({"game": "toy", "population_size": 6, "episode_cutoff_mode": 5,
                                   "noise_size": COUNT, "env_kwargs": {"batch_size": 4}}),
    ])
    tr = tmain.cmd_train(args)
    assert isinstance(tr, tga.GATrainer) and tr.state.it == 2
    lens = [len(o.seeds) for o in tr.state.population]
    assert len(lens) == 6 and set(lens) <= {1, 2} and lens.count(2) >= 5
