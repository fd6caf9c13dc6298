"""The port's device rollout, its ES device arm and its config for the
device envs against the JAX package's, on the CPU.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX package drew: reset states, noise offsets, random actions, θ.
Tolerances, fixed before the comparison:

* ``rollout_batch`` at B=8 and cutoff 50 (free-running episodes, so a short
  cutoff): lengths and CartPole's returns exactly; other returns, sign
  returns, BCs and obs-stat sums within rtol 1e-5 / atol 1e-4 (float32
  sums over 50 steps in another order);
* one ES generation (population 16, cutoff 30): returns and lengths as
  above, BCs within atol 1e-4, the gradient within 1e-5·max|g|, θ' by
  tests/test_torch_es.py's rule for Adam near G = 0, the obs stats within
  rtol 1e-5.
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
from deep_neuroevolution_torch import main as cli
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.algos import rollout as trollout
from deep_neuroevolution_torch.ops import fitness as tfit
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
from deep_neuroevolution_torch.utils import checkpoint
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos import rollout as jrollout
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import tabular as jtab

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
COUNT = 2_000_000


def _to_torch_state(tenv, jstate):
    """A JAX state pytree as the port's state NamedTuple of the same env."""
    cls = type(tenv.reset(1, torch.Generator(), CPU))
    return cls(*(torch.from_numpy(np.array(f)) for f in jstate))


def _members(jm, B, seed, bias=0.0):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    th = np.stack([np.asarray(jm.init_theta(k)) for k in keys])
    return th + np.random.RandomState(seed).normal(0, bias, th.shape).astype(np.float32) if bias else th


# (env, model kwargs, ctx, obstat mask): CartPole ends episodes early (the
# done mask and the early exit); the maze's BC is a position; Pendulum runs
# MujocoMLP with obs normalization and a per-rollout obs-stat mask
CASES = {
    "cartpole": ("gym.CartPole-v1", "SimpleClassifier", dict(obs_dim=4, num_actions=2), False),
    "maze": ("maze", "ContinuousMLP", dict(obs_dim=11, ac_dim=2), False),
    "pendulum": ("gym.Pendulum-v1", "MujocoPolicy",
                 dict(obs_dim=3, ac_dim=1, ac_low=(-2.0,), ac_high=(2.0,), hidden_dims=(16, 16)), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_batch_against_jax(case):
    env_id, model_name, kw, with_ctx = CASES[case]
    B, cutoff = 8, 50
    jenv, tenv = jenvs.make(env_id), tenvs.make(env_id)
    jm, tm = jmodels.get_model(model_name)(**kw), tmodels.get_model(model_name)(**kw)
    thetas = _members(jm, B, 11, bias=0.3)
    keys = jax.random.split(jax.random.PRNGKey(12), B)
    mask = (np.arange(B) % 3 != 0).astype(np.float32)
    jctx = tctx = None
    if with_ctx:
        mean, std = np.array([0.1, -0.2, 0.3], np.float32), np.array([0.9, 1.1, 2.0], np.float32)
        jctx = jmodels.MLPContext(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(0.0, jnp.float32))
        tctx = tmodels.MLPContext(torch.from_numpy(mean), torch.from_numpy(std), 0.0)
    j = jrollout.rollout_batch(jenv, jm.make_batch_act(), (jnp.asarray(thetas), jctx), keys,
                               jnp.asarray(cutoff, jnp.int32), True, jnp.asarray(mask))
    state0 = _to_torch_state(tenv, jax.vmap(jenv.reset)(keys))  # the JAX reset states fed in
    t = trollout.rollout_batch(tenv, tm.make_batch_act(), (weights.from_jax(thetas, device="cpu"), tctx), state0,
                               cutoff, True, torch.from_numpy(mask))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    assert t.lengths.dtype == torch.int32 and t.returns.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-4)
    if case == "cartpole":
        np.testing.assert_array_equal(t.returns.numpy(), np.asarray(j.returns))
        assert (t.lengths < cutoff).any()  # some episodes ended early
    np.testing.assert_allclose(t.returns.numpy(), np.asarray(j.returns), **tol)
    np.testing.assert_allclose(t.sign_returns.numpy(), np.asarray(j.sign_returns), **tol)
    np.testing.assert_allclose(t.bc.numpy(), np.asarray(j.bc), **tol)
    np.testing.assert_allclose(t.ob_sum.numpy(), np.asarray(j.ob_sum), **tol)
    np.testing.assert_allclose(t.ob_sumsq.numpy(), np.asarray(j.ob_sumsq), **tol)
    assert float(t.ob_count) == float(j.ob_count) == float((t.lengths.numpy() * mask).sum())


def test_early_exit_changes_nothing(monkeypatch):
    """Reading "every slot done" every step or every CHECK_EVERY steps (the
    masked steps in between) gives the same results, bit for bit."""
    env = tenvs.make("gym.CartPole-v1")
    m = tmodels.SimpleClassifier(obs_dim=4, num_actions=2)
    gen = torch.Generator().manual_seed(0)
    thetas = torch.stack([m.init_theta(gen) for _ in range(16)])
    state = env.reset(16, torch.Generator().manual_seed(1), CPU)
    runs = []
    for every in (1, trollout.CHECK_EVERY, 10_000):
        monkeypatch.setattr(trollout, "CHECK_EVERY", every)
        runs.append(trollout.rollout_batch(env, m.make_batch_act(), (thetas, None), state, 300, True))
    for r in runs[1:]:
        for a, b in zip(r, runs[0]):
            assert torch.equal(a, b)
    assert int(runs[0].lengths.max()) < 300


def test_paired_reset_halves_alike():
    s = trollout.paired_reset(tenvs.CartPoleEnv(), 5, torch.Generator().manual_seed(2), CPU)
    for f in s[:4]:
        assert f.shape == (10,) and torch.equal(f[:5], f[5:]) and len(set(f[:5].tolist())) == 5


def test_collect_ref_batch_against_jax(monkeypatch):
    """The maze (deterministic resets) under the JAX package's random
    actions: the same observations, within 1e-5."""
    key, batch, slots = jax.random.PRNGKey(5), 40, 8
    jenv, tenv = jenvs.make("maze"), tenvs.make("maze")
    j = np.asarray(jrollout.collect_ref_batch(jenv, key, batch_size=batch, slots=slots))
    _, kact = jax.random.split(key)
    actions = iter([torch.from_numpy(np.asarray(
        jax.random.uniform(jax.random.fold_in(kact, t), (slots, 2), minval=-0.5, maxval=0.5)))
        for t in range(-(-batch // slots))])
    monkeypatch.setattr(trollout, "random_actions", lambda env, n, gen, device: next(actions))
    t = trollout.collect_ref_batch(tenv, torch.Generator().manual_seed(0), CPU, batch_size=batch, slots=slots)
    assert t.shape == (batch, 11) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-5)


def test_random_actions_in_range():
    gen = torch.Generator().manual_seed(0)
    a = trollout.random_actions(tenvs.make("maze"), 1000, gen, CPU)
    assert a.shape == (1000, 2) and float(a.min()) >= -0.5 and float(a.max()) < 0.5
    d = trollout.random_actions(tenvs.make("gym.CartPole-v1"), 1000, gen, CPU)
    assert set(d.tolist()) == {0, 1}


# ------------------------------------------------------------ generation


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


class _InjectedTrainer(tes.ESTrainer):
    """The port's trainer, handed each round's noise offsets and the reset
    states of the rounds and the eval episodes."""

    def __init__(self, *a, rounds, starts, **kw):
        super().__init__(*a, **kw)
        self._rounds, self._starts = list(rounds), dict(starts)

    def _draw_round(self, npairs):
        idxs = self._rounds.pop(0)
        assert idxs.shape == (npairs,)
        return torch.from_numpy(np.array(idxs)), 0

    def _episode_starts(self, seed, n, paired):
        state = self._starts.pop("round" if paired else "eval")
        assert state[0].shape == ((2 * n,) if paired else (n,))
        return state, self._episode_gen(seed)


GEN_CASES = {  # env, model name and kwargs, ESConfig fields, Adam step
    "maze": ("maze", "ContinuousMLP", dict(obs_dim=11, ac_dim=2), dict(noise_stdev=0.05), 0.05),
    "cartpole": ("gym.CartPole-v1", "SimpleClassifier", dict(obs_dim=4, num_actions=2), {}, 0.01),
    "pendulum": ("gym.Pendulum-v1", "MujocoPolicy",
                 dict(obs_dim=3, ac_dim=1, ac_low=(-2.0,), ac_high=(2.0,), hidden_dims=(16, 16), ac_noise_std=0.0),
                 dict(calc_obstat_prob=1.0), 0.01),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_one_generation_matches_jax(case, quiet_loggers):
    """One fixed-population generation (population 16, cutoff 30), the JAX
    package's ``_fused_generation`` (use_pallas=False) against the port's
    device arm with the JAX draws fed in: returns, lengths, BCs, eval
    returns and lengths, g, θ', the obs stats and the tabular row."""
    env_id, model_name, kw, cfg_kw, lr = GEN_CASES[case]
    pop, cutoff, npairs = 16, 30, 8
    jenv, tenv = jenvs.make(env_id), tenvs.make(env_id)
    jm, tm = jmodels.get_model(model_name)(**kw), tmodels.get_model(model_name)(**kw)
    jtr = jes.ESTrainer(jenv, jm, jes.ESConfig(population_size=pop, episode_cutoff_mode=cutoff, **cfg_kw),
                        optimizer=jopt.Adam(stepsize=lr), noise_table=JaxNoise.from_seed(count=COUNT), seed=3)
    assert not jtr.config.use_pallas_grad  # _fused_generation with use_pallas=False
    theta0, key = np.asarray(jtr.state.theta), jtr.state.key
    jstats = jtr.train_step()
    # the draws of train_step's _fused_generation: its rounds' offsets and
    # episode keys, and the eval episodes' keys
    key, keval = jax.random.split(key)
    key, kround = jax.random.split(key)
    kidx, kroll = jax.random.split(jax.random.split(kround, 1)[0])
    idxs = np.asarray(jax.random.randint(kidx, (npairs,), 0, COUNT - jm.num_params + 1, dtype=jnp.int32))
    ep_seeds = jax.random.randint(kroll, (npairs,), 0, 2**31 - 1, dtype=jnp.int32)
    keys = jax.vmap(lambda s: jax.random.PRNGKey(s.astype(jnp.uint32)))(ep_seeds)
    starts = {
        "round": _to_torch_state(tenv, jax.vmap(jenv.reset)(jnp.concatenate([keys, keys]))),
        "eval": _to_torch_state(tenv, jax.vmap(jenv.reset)(jax.random.split(keval, 8))),
    }
    ttr = _InjectedTrainer(
        tenv, tm, tes.ESConfig(population_size=pop, episode_cutoff_mode=cutoff, **cfg_kw),
        optimizer=topt.Adam(stepsize=lr), noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"),
        seed=3, device="cpu", rounds=[idxs], starts=starts,
    )
    ttr.theta = weights.from_jax(theta0, device="cpu")
    tstats = ttr.train_step()

    np.testing.assert_array_equal(tstats.lengths, jstats.lengths)
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tstats.returns, jstats.returns, **tol)
    np.testing.assert_allclose(tstats.bc, jtr._last_bcs, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tstats.eval_lengths, np.asarray(jstats.eval_lengths))
    np.testing.assert_allclose(tstats.eval_returns, np.asarray(jstats.eval_returns), **tol)
    assert tstats.returns.shape == (npairs, 2) and tstats.eval_returns.shape == (8,)
    if case == "cartpole":  # returns are lengths: the ranks are equal too
        np.testing.assert_array_equal(tstats.returns, jstats.returns)
        assert len(np.unique(jstats.returns)) > 4

    # the gradient both packages' way, from the JAX returns
    srets = np.zeros_like(jstats.returns)
    jw = jfit.process_returns(jnp.asarray(jstats.returns), jnp.asarray(srets), "centered_rank")
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(idxs), jw[:, 0] - jw[:, 1],
                                             jm.num_params)) / jstats.returns.size
    tw = tfit.process_returns(torch.from_numpy(tstats.returns), torch.from_numpy(srets), "centered_rank")
    tg = noise_gradient(ttr.noise.noise, torch.from_numpy(idxs), (tw[:, 0] - tw[:, 1]).contiguous(),
                        tm.num_params).numpy() / tstats.returns.size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-5 * gmax)
    # θ': test_torch_es.py's rule (Adam's first step is steep near G = 0)
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + 0.005 * theta0
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(G) + eps_) ** 2 < 1e-6
    ttheta, jtheta = ttr.theta.numpy(), np.asarray(jtr.state.theta)
    np.testing.assert_allclose(ttheta[steady], jtheta[steady], rtol=0, atol=1e-6)
    assert np.abs(ttheta - theta0).max() <= lr * (1 + 1e-5) and steady.mean() > 0.9

    for a, b in zip(ttr.ob_stat, jtr.state.ob_stat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    if case == "pendulum":
        assert float(ttr.ob_stat.count) > 1  # merged: calc_obstat_prob = 1
    (jrow,), (trow,) = quiet_loggers["jax"], quiet_loggers["torch"]
    for name in ("EpLenMean", "TimestepLimitPerEpisode", "EvalEpCount", "EvalEpLenMean", "EpisodesThisIter",
                 "TimestepsThisIter", "ObCount"):
        assert float(trow[name]) == float(jrow[name]), name
    assert set(jrow) - {"UniqueWorkers"} <= set(trow)


def test_obstat_sampling_counts_a_share_of_rollouts(quiet_loggers):
    """calc_obstat_prob in (0, 1): each rollout joins the obs stats with
    that probability, so ObCount covers some but not all steps, and the
    running stats take exactly those sums."""
    env = tenvs.make("gym.Pendulum-v1")
    m = tmodels.MujocoMLP(obs_dim=3, ac_dim=1, ac_low=(-2.0,), ac_high=(2.0,), hidden_dims=(8,))
    tr = tes.ESTrainer(env, m, tes.ESConfig(population_size=64, episode_cutoff_mode=10, calc_obstat_prob=0.5),
                       noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), device="cpu")
    tr.train_step()
    (row,) = quiet_loggers["torch"]
    assert 0 < row["ObCount"] < row["TimestepsThisIter"] and row["ObCount"] % 10 == 0
    np.testing.assert_allclose(float(tr.ob_stat.count), 1e-2 + row["ObCount"], rtol=1e-6)


# ---------------------------------------------------------------- config

SMALL = {"population_size": 16, "episode_cutoff_mode": 30, "noise_size": 3_000_000}
REFERENCE_NAMES = ("EpRewMean", "EpRewStd", "EpLenMean", "EvalEpRewMean", "EvalEpRewMedian", "EvalEpRewStd",
                   "EvalEpLenMean", "EvalPopRank", "EvalEpCount", "Norm", "GradNorm", "UpdateRatio",
                   "EpisodesThisIter", "EpisodesSoFar", "TimestepsThisIter", "TimestepsSoFar", "UniqueWorkers",
                   "UniqueWorkersFrac", "ResultsSkippedFrac", "ObCount", "TimeElapsedThisIter", "TimeElapsed",
                   "TimestepsPerSecondThisIter")


def _exp(name):
    return json.loads((ROOT / "configurations" / name).read_text())


def test_both_configurations_load_on_the_cpu():
    maze = tconfig.load_experiment(_exp("maze_es.json"), overrides={"noise_size": 3_000_000}, device="cpu")
    assert isinstance(maze.env, tenvs.MazeEnv) and not maze.is_host_env
    assert isinstance(maze.model, tmodels.ContinuousMLP) and maze.model.num_params == 498
    assert (maze.config.population_size, maze.config.noise_stdev, maze.config.num_eval_episodes) == (512, 0.05, 8)
    assert maze.cutoff.tslimit == 400 and maze.optimizer.stepsize == 0.05
    gym = tconfig.load_experiment(_exp("es_gym_config.json"), overrides={"noise_size": 3_000_000}, device="cpu")
    assert isinstance(gym.env, tenvs.CartPoleEnv) and isinstance(gym.model, tmodels.SimpleClassifier)
    assert gym.model.num_params == 386 and gym.config.population_size == 5000 and gym.cutoff.tslimit == 5000
    assert gym.optimizer.stepsize == 0.01 and gym.config.noise_stdev == 0.02
    # the port's overrides apply to both
    for tr in (tconfig.load_experiment(_exp(f), overrides={**SMALL, "num_eval_episodes": 3,
                                                           "theta_hbm_budget": 2 * 4 * 500 * 2},
                                       device="cpu") for f in ("maze_es.json", "es_gym_config.json")):
        assert (tr.config.population_size, tr.cutoff.tslimit, tr.noise.size, tr.config.num_eval_episodes) == (
            16, 30, 3_000_000, 3)
        assert tr._npairs_round() == 2


def test_config_rejects_what_is_not_ported(tmp_path, monkeypatch):
    maze = _exp("maze_es.json")
    # MuJoCo ids load since the engine was ported (tests/test_torch_mujoco.py
    # loads both humanoid files); without gymnasium and mujoco they raise,
    # naming both
    from deep_neuroevolution_torch.envs import mujoco as tmujoco

    monkeypatch.setattr(tmujoco, "is_available", lambda: False)
    for exp in (_exp("humanoid.json"), {**maze, "env_id": "Humanoid-v1"}):
        with pytest.raises(RuntimeError, match="needs gymnasium and mujoco"):
            tconfig.load_experiment(exp, overrides={"noise_size": 3_000_000}, device="cpu")
    monkeypatch.undo()
    # the GA's device arm and its CPU-style genomes now load
    tr = tconfig.load_experiment({**maze, "algo": "ga"}, overrides={"noise_size": 3_000_000}, device="cpu")
    assert isinstance(tr, tga.GATrainer) and tr.config.genome_style == "cpu" and not tr.is_host_env
    tr = tconfig.load_experiment(_exp("es_gym_config.json"), overrides=SMALL, device="cpu", algo="ga")
    assert isinstance(tr, tga.GATrainer) and tr.config.genome_style == "gpu"
    # quota mode, mirror_crn and the policy's init_from now act
    for quota in ("episodes_per_batch", "timesteps_per_batch"):
        tr = tconfig.load_experiment({**maze, "config": {**maze["config"], quota: 100}},
                                     overrides={"noise_size": 3_000_000}, device="cpu")
        assert tr.quota_mode and getattr(tr.config, quota) == 100
    tr = tconfig.load_experiment({**maze, "config": {**maze["config"], "mirror_crn": True}},
                                 overrides={"noise_size": 3_000_000}, device="cpu")
    assert tr.config.mirror_crn
    policy = tmp_path / "x.h5"  # a policy file of the same model: the warm start copies all of it
    theta = torch.from_numpy(np.random.RandomState(0).randn(tr.model.num_params).astype(np.float32))
    checkpoint.save_policy_snapshot(str(policy), tr.model, theta)
    tr = tconfig.load_experiment({**maze, "policy": {"type": "ContinuousMLP", "args": {"init_from": str(policy)}}},
                                 overrides={"noise_size": 3_000_000}, device="cpu")
    assert torch.equal(tr.theta, theta)


@pytest.mark.parametrize("name", ["maze_es.json", "es_gym_config.json"])
def test_cli_trains_on_the_cpu_and_needs_a_card_otherwise(name, quiet_loggers, monkeypatch):
    """``main train --device cpu`` runs a generation and logs the
    reference's tabular names; without ``--device cpu`` and without a card
    it stops with NoCudaDevice."""
    argv = ["train", "--exp_file", str(ROOT / "configurations" / name), "--overrides", json.dumps(SMALL)]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    (row,) = quiet_loggers["torch"]
    assert set(REFERENCE_NAMES) <= set(row) and row["EpisodesThisIter"] == 16 and row["EvalEpCount"] == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 1
    with pytest.raises(NoCudaDevice):
        tconfig.load_experiment(_exp(name), overrides=SMALL)
    with pytest.raises(NoCudaDevice):
        tes.ESTrainer(tenvs.make("maze"), tmodels.ContinuousMLP(obs_dim=11, ac_dim=2),
                      tes.ESConfig(population_size=4), noise_table=TorchNoise(torch.zeros(1000)))
