"""The port's NS-ES and NSR-ES against the JAX package's, on the CPU: the
novelty ops, EpisodicLife on the host engine, the trajectory BC, one
iteration on the maze and one on ToyCatch, the loader and the CLI.

JAX's key streams cannot be reproduced in torch, so the port is handed what
the JAX package drew: parents' θ, the archive, the reference batch, each
round's noise offsets and the host rollouts' seeds (from which both
packages draw the noop counts and the engine's episode seeds in the same
order). With EpisodicLife a reset after a life lost goes on with the game,
so every engine comparison starts both packages on fresh engines and runs
them through the same rollouts. Tolerances, fixed before the comparison:

* the host float64 novelty, the RAM trajectories, lengths and ToyCatch
  returns: exact;
* ``novelty_vs_archive`` on equal inputs: rtol 1e-6;
* maze returns, BCs and novelty from the two packages' own rollouts: rtol
  1e-5 / atol 1e-4 (test_torch_rollout.py's rollout tolerance); the
  processed ranks from equal inputs: exact; g within 1e-5·max|g|; θ' by
  test_torch_es.py's rule for Adam's first step near G = 0; the
  ``novelty_prob`` probabilities within rtol 1e-5.
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
from deep_neuroevolution_torch.algos import nses as tnses
from deep_neuroevolution_torch.algos.rollout_host import rollout_host_batch as t_rollout_host
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.ops import novelty as tnov
from deep_neuroevolution_torch.ops import obstat as tobstat
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_tpu import envs as jenvs
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.algos import es as jes
from deep_neuroevolution_tpu.algos import nses as jnses
from deep_neuroevolution_tpu.algos import rollout as jrollout
from deep_neuroevolution_tpu.algos.rollout_host import rollout_host_batch as j_rollout_host
from deep_neuroevolution_tpu.envs.atari import AtariEnv as JaxAtari
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import novelty as jnov
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise
from deep_neuroevolution_tpu.utils import config as jconfig
from deep_neuroevolution_tpu.utils import tabular as jtab

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
COUNT = 2_000_000
NS_NAMES = ("ParentId", "EpRewMean", "EpRewStd", "EpLenMean", "EpNovMean", "Norm", "GradNorm", "UpdateRatio",
            "EpisodesThisIter", "EpisodesSoFar", "TimestepsThisIter", "TimestepsSoFar", "ObCount", "ArchiveSize",
            "TimeElapsedThisIter", "TimeElapsed")


def _jax_seed(key) -> int:
    """The host RNG seed the JAX package derives from a rollout key."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


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


# ------------------------------------------------------------- novelty ops


def _ragged(rs, n):
    return [rs.randint(0, 256, size=128 * rs.randint(1, 6)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("ragged", [False, True])
def test_host_novelty_bit_exact(ragged):
    rs = np.random.RandomState(3 + ragged)
    archive = _ragged(rs, 12) if ragged else [rs.randn(40).astype(np.float32) * 100 for _ in range(12)]
    probes = _ragged(rs, 5) if ragged else [rs.randn(40).astype(np.float32) * 100 for _ in range(5)]
    for x in probes:
        for y in archive:
            assert tnov.euclidean_distance(x, y) == jnov.euclidean_distance(x, y)
            assert tnov.euclidean_distance(y, x) == jnov.euclidean_distance(y, x)
        for k in (1, 5, 20):  # 20 > the archive: the mean runs over all 12
            assert tnov.compute_novelty_vs_archive(archive, x, k) == jnov.compute_novelty_vs_archive(archive, x, k)


@pytest.mark.parametrize("count", [3, 10, 37])  # below, at and above k = 10
def test_novelty_vs_archive_against_jax(count):
    """Maze-scale BCs (0-300), rows past the count stale (not zero): the
    JAX function's values within rtol 1e-6."""
    rs = np.random.RandomState(count)
    cap, k = 48, 10
    points = rs.uniform(0, 300, size=(cap, 2)).astype(np.float32)  # every row filled: the stale ones too
    bcs = rs.uniform(0, 300, size=(64, 2)).astype(np.float32)
    bcs[0] = points[0]  # a zero distance
    j = np.asarray(jnov.novelty_vs_archive(jnov.Archive(jnp.asarray(points), jnp.asarray(count, jnp.int32)),
                                           jnp.asarray(bcs), k))
    ta = tnov.Archive(torch.from_numpy(points), torch.tensor(count, dtype=torch.int32))
    t = tnov.novelty_vs_archive(ta, torch.from_numpy(bcs), k).numpy()
    assert t.shape == (64,) and t.dtype == np.float32
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)
    # and the host definition over the valid rows
    host = [jnov.compute_novelty_vs_archive(list(points[:count]), b, k) for b in bcs[:8]]
    np.testing.assert_allclose(t[:8], host, rtol=1e-5)


def test_archive_grows_and_keeps_every_point_in_order():
    rs = np.random.RandomState(0)
    pts = rs.uniform(0, 300, size=(11, 2)).astype(np.float32)
    a = tnov.archive_init(2, 2, CPU)
    snapshots = []
    for p in pts:
        snapshots.append(a)
        a = tnov.archive_add(a, torch.from_numpy(p))
    assert int(a.count) == 11 and a.points.shape == (16, 2)  # 2 → 4 → 8 → 16
    np.testing.assert_array_equal(a.points[:11].numpy(), pts)
    assert int(snapshots[5].count) == 5  # an earlier archive is left as it was
    np.testing.assert_array_equal(snapshots[5].points[:5].numpy(), pts[:5])
    j = jnov.archive_init(2, 2)
    for p in pts:
        j = jnov.archive_add(j, jnp.asarray(p))
    np.testing.assert_array_equal(a.points.numpy(), np.asarray(j.points))


# ------------------------------------------------------------ host engine


def test_episodic_life_matches_jax():
    """From the same noops and engine seeds and the same actions, the two
    packages' EpisodicLife engines give the same done, reward and RAM,
    through life losses and the resets that go on with the game."""
    B, rs = 6, np.random.RandomState(1)
    j = JaxAtari("toy", batch_size=B, num_threads=2, episodic_life=True)
    t = TorchAtari("toy", batch_size=B, num_threads=2, episodic_life=True)
    assert t.episodic_life and t.bc_dim == 128
    dones = 0
    for _ in range(3):
        noops, seeds = rs.randint(1, 31, B), rs.randint(1, 2**31 - 1, B).astype(np.int32)
        j.reset(noops=noops, max_frames=4000, seeds=seeds)
        t.reset(noops, max_frames=4000, seeds=seeds)
        np.testing.assert_array_equal(t.final_state(), j.final_state())
        for _ in range(120):
            a = rs.randint(0, 4, B)
            jr, jd = j.step(a)
            tr, td = t.step(a)
            np.testing.assert_array_equal(td, jd)
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(t.final_state(), j.final_state())
            np.testing.assert_array_equal(t.observe(), j.observe())
            dones += int(td.sum())
    j.close()
    t.close()
    assert dones > 0  # lives were lost


def _vbn_members(jm, B, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return np.stack([np.asarray(jm.init_theta(k)) for k in keys])


def test_trajectory_bc_matches_jax():
    """``rollout_host_batch(collect_bc_traj=True)`` on fresh EpisodicLife
    engines, B=8 in two pipeline groups, a VBN-DQN population carried
    across: the same lengths, returns and every RAM row."""
    B, cutoff = 8, 40
    jm, tm = JaxVBN(num_actions=4), tmodels.VirtualBNDQN(num_actions=4)
    thetas = _vbn_members(jm, B, 4)
    ref = np.random.RandomState(4).uniform(0, 1, size=(16, 84, 84, 4)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    j = JaxAtari("toy", batch_size=B, num_threads=2, pipeline_groups=2, episodic_life=True)
    jstats = jm.batch_ref_stats(jnp.asarray(thetas), jnp.asarray(ref))
    jr = j_rollout_host(j, jm.make_batch_act(), (jnp.asarray(thetas), jstats), key, cutoff, collect_bc_traj=True)
    j.close()
    t = TorchAtari("toy", batch_size=B, num_threads=2, pipeline_groups=2, episodic_life=True)
    tth = weights.from_jax(thetas, device="cpu")
    tstats = tm.batch_ref_stats(tth, torch.from_numpy(ref))
    tr = t_rollout_host(t, tm.make_batch_act(), (tth, tstats), _jax_seed(key), cutoff, CPU, collect_bc_traj=True)
    t.close()
    np.testing.assert_array_equal(tr.lengths, np.asarray(jr.lengths))
    np.testing.assert_array_equal(tr.returns, np.asarray(jr.returns))
    assert len(tr.bc_traj) == B and (tr.lengths < cutoff).any()  # some episodes ended on a life lost
    for b in range(B):
        assert tr.bc_traj[b].dtype == np.float32 and tr.bc_traj[b].shape == (128 * tr.lengths[b],)
        np.testing.assert_array_equal(tr.bc_traj[b], jr.bc_traj[b])
    np.testing.assert_array_equal(tr.bc, np.asarray(jr.bc))


# ------------------------------------------------------------- iterations


class _InjectedNS(tnses.NSESTrainer):
    """The port's trainer, given each round's noise offsets and rollout
    seed, and the seeds of the mean-BC rollouts that follow."""

    def __init__(self, *a, rounds, **kw):
        self._seeds = None
        super().__init__(*a, **kw)
        self._rounds = list(rounds)

    def _draw_round(self, npairs):
        idxs, seed = self._rounds.pop(0)
        assert idxs.shape == (npairs,)
        return torch.from_numpy(np.array(idxs)), seed

    def _draw_seed(self):
        return self._seeds.pop(0) if self._seeds else super()._draw_seed()

    def inject(self, thetas, archive, ref_batch=None):
        D = self.model.num_params
        self.parents = [tnses.Parent(weights.from_jax(th, device="cpu"), self.optimizer.init(D, CPU),
                                     tobstat.init(self.env.obs_shape, eps=1e-2, device=CPU)) for th in thetas]
        if self.traj_bc:
            self.host_archive = [np.array(a) for a in archive]
        else:
            self.archive = tnov.Archive(torch.from_numpy(np.array(archive.points)),
                                        torch.tensor(int(archive.count), dtype=torch.int32))
        if ref_batch is not None:
            self.ref_batch = weights.from_jax(np.asarray(ref_batch), device="cpu")
        self.curr_parent = 0


def _check_update(tst, ttr, jtr, theta0, jrets, jnov_, idxs, mode, algo, lr, l2=0.005):
    """Ranks from equal inputs exact; g within 1e-5·max|g|; θ' by the
    steady rule (test_torch_es.py)."""
    jproc = jfit.process_returns(jnp.asarray(jrets), jnp.asarray(jnov_), mode)
    if algo == "nsr":
        jproc = (jfit.compute_centered_ranks(jnp.asarray(jrets)) + jproc) / 2.0
    tproc = ttr._process_returns(torch.from_numpy(np.array(jrets)), torch.from_numpy(np.array(jnov_)))
    np.testing.assert_array_equal(tproc.numpy(), np.asarray(jproc))
    D = ttr.model.num_params
    jg = np.asarray(jfit.gradient_from_noise(jtr.noise.noise, jnp.asarray(idxs), jproc[:, 0] - jproc[:, 1], D))
    jg = jg / jrets.size
    gmax = np.abs(jg).max()
    np.testing.assert_allclose(tst.g.numpy(), jg, rtol=0, atol=1e-5 * gmax)
    eps_ = 1e-8 / np.sqrt(1 - 0.999)
    G = -jg + l2 * theta0
    steady = lr * eps_ * (1e-5 * gmax) / (np.abs(G) + eps_) ** 2 < 1e-6
    ttheta, jtheta = ttr.parents[tst.parent].theta.numpy(), np.asarray(jtr.parents[tst.parent].theta)
    np.testing.assert_allclose(ttheta[steady], jtheta[steady], rtol=0, atol=1e-6)
    assert np.abs(ttheta - theta0).max() <= lr * (1 + 1e-5)
    return ttheta


def _check_rows(rows, archive_size):
    (jrow,), (trow,) = rows["jax"], rows["torch"]
    assert set(jrow) == set(trow) == set(NS_NAMES)
    for name in ("ParentId", "EpisodesThisIter", "TimestepsThisIter", "EpLenMean", "ArchiveSize", "ObCount"):
        assert float(trow[name]) == float(jrow[name]), name
    assert trow["ArchiveSize"] == archive_size


@pytest.mark.parametrize("algo,selection", [("ns", "round_robin"), ("nsr", "novelty_prob")])
def test_maze_iteration_matches_jax(algo, selection, quiet_loggers):
    """One iteration on the maze (ContinuousMLP, population 16, cutoff 30,
    M = 3, k = 3, an archive of capacity 2 that grows): the rollouts, their
    BCs and novelty, the ranks, g, θ', the archive's new row (the JAX
    function on the port's updated parents) and novelty_prob's
    probabilities."""
    pop, cutoff, npairs, lr = 16, 30, 8, 0.01
    kw = dict(population_size=pop, episode_cutoff_mode=cutoff, noise_stdev=0.05, algo_type=algo, k=3,
              meta_population_size=3, selection_method=selection, archive_capacity=2)
    jenv, tenv = jenvs.make("maze"), tenvs.make("maze")
    jm, tm = jmodels.ContinuousMLP(obs_dim=11, ac_dim=2), tmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
    jtr = jnses.NSESTrainer(jenv, jm, jnses.NSESConfig(**kw), optimizer=jopt.Adam(stepsize=lr),
                            noise_table=JaxNoise.from_seed(count=COUNT), seed=5)
    key, thetas, archive = jtr.key, [np.asarray(p.theta) for p in jtr.parents], jtr.archive
    assert int(archive.count) == 3 and archive.points.shape[0] == 4
    jres = jtr.train_step()
    # the draws of train_step's _perturbed_eval_with_bc
    kidx, kroll = jax.random.split(jax.random.split(key)[1])
    D = jm.num_params
    idxs = np.asarray(jax.random.randint(kidx, (npairs,), 0, COUNT - D + 1, dtype=jnp.int32))

    ttr = _InjectedNS(tenv, tm, tnses.NSESConfig(**kw), optimizer=topt.Adam(stepsize=lr),
                      noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"), seed=5, device="cpu",
                      rounds=[(idxs, 0)])
    ttr.inject(thetas, archive)
    tst = ttr.train_step()

    # the rollouts: the JAX package's, with its draws
    eps = np.asarray(jtr.noise.noise)[idxs[:, None] + np.arange(D)]
    jth = np.concatenate([thetas[0] + 0.05 * eps, thetas[0] - 0.05 * eps]).astype(np.float32)
    keys = jax.random.split(kroll, npairs)
    jr = jrollout.rollout_batch(jenv, jm.make_batch_act(), (jnp.asarray(jth), None), jnp.concatenate([keys, keys]),
                                jnp.asarray(cutoff, jnp.int32))
    pair = lambda x: np.stack([np.asarray(x)[:npairs], np.asarray(x)[npairs:]], axis=1)  # noqa: E731
    tol = dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(tst.lengths, jres["lengths"])
    np.testing.assert_allclose(tst.returns, jres["returns"], **tol)
    np.testing.assert_allclose(tst.bc, pair(jr.bc), **tol)
    np.testing.assert_allclose(tst.novelty, jres["novelty"], **tol)
    assert tst.bc.shape == (npairs, 2, 2) and tst.novelty.shape == (npairs, 2)
    # the novelty of the port's BCs, both packages' way
    jn = np.asarray(jnov.novelty_vs_archive(archive, jnp.asarray(tst.bc.reshape(-1, 2)), 3)).reshape(npairs, 2)
    np.testing.assert_allclose(tst.novelty, jn, rtol=1e-6)
    np.testing.assert_array_equal(np.argsort(tst.novelty, axis=None), np.argsort(jres["novelty"], axis=None))

    ttheta = _check_update(tst, ttr, jtr, thetas[0], jres["returns"], jres["novelty"], idxs,
                           "centered_sign_rank", algo, lr)
    # the archive's new row: the JAX function's mean BC of the port's updated parent
    tth = np.stack([ttheta, thetas[1], thetas[2]])
    jbcs = np.asarray(jnses._mean_bc_parents(jenv, jm, jnp.asarray(tth), jax.random.PRNGKey(0),
                                             jnp.asarray(cutoff, jnp.int32), 1))
    assert int(ttr.archive.count) == 4 and ttr.archive.points.shape[0] == 4
    np.testing.assert_array_equal(ttr.archive.points[:3].numpy(), np.asarray(archive.points)[:3])
    np.testing.assert_allclose(ttr.archive.points[3].numpy(), jbcs[0], **tol)
    np.testing.assert_allclose(tst.new_bc, jbcs[0], **tol)
    if selection == "novelty_prob":
        jarch = jnov.archive_add(archive, jnp.asarray(tst.new_bc))
        novs = np.asarray(jnov.novelty_vs_archive(jarch, jnp.asarray(jbcs), 3))
        np.testing.assert_allclose(tst.selection_probs, novs / novs.sum(), rtol=1e-5)
        assert tst.selection_probs.shape == (3,) and 0 <= ttr.curr_parent < 3
    else:
        assert tst.selection_probs is None and ttr.curr_parent == jtr.curr_parent == 1
    _check_rows(quiet_loggers, 4)


def test_host_iteration_matches_jax(quiet_loggers):
    """One NSR iteration on ToyCatch with EpisodicLife and the trajectory
    BC: population 4 on 8 slots (the JAX package pads θ before the
    reference stats, the port after), M = 2, k = 2. The rollouts'
    returns, lengths and trajectories, their float64 novelty, the ranks,
    g, θ' and the archive's new trajectory (the JAX package's mean BC of
    the port's updated parent, on an engine with the same history)."""
    slots, pop, cutoff, npairs, lr = 8, 4, 20, 2, 0.01
    kw = dict(population_size=pop, episode_cutoff_mode=cutoff, algo_type="nsr", k=2, meta_population_size=2,
              selection_method="round_robin", bc_mode="traj")
    eng = dict(batch_size=slots, num_threads=2, pipeline_groups=2, episodic_life=True)
    jm = JaxVBN(num_actions=4)
    jtr = jnses.NSESTrainer(JaxAtari("toy", **eng), jm, jnses.NSESConfig(**kw), optimizer=jopt.Adam(stepsize=lr),
                            noise_table=JaxNoise.from_seed(count=COUNT), seed=7)
    key, thetas, archive = jtr.key, [np.asarray(p.theta) for p in jtr.parents], list(jtr.host_archive)
    assert len(archive) == 2
    key, k1 = jax.random.split(key)
    _, k2 = jax.random.split(key)
    D = jm.num_params
    idxs = np.asarray(jax.random.randint(k1, (npairs,), 0, COUNT - D + 1, dtype=jnp.int32))
    jtr.env.close()
    jtr.env = JaxAtari("toy", **eng)  # fresh engines on both sides
    jres = jtr.train_step()
    jtr.env.close()

    tenv = TorchAtari("toy", **eng)
    ttr = _InjectedNS(tenv, tmodels.VirtualBNDQN(num_actions=4), tnses.NSESConfig(**kw),
                      optimizer=topt.Adam(stepsize=lr), noise_table=TorchNoise.from_seed(count=COUNT, device="cpu"),
                      seed=7, device="cpu", rounds=[(idxs, _jax_seed(k1))])
    ttr.inject(thetas, archive, jtr.ref_batch)
    ttr.env.close()
    ttr.env = TorchAtari("toy", **eng)
    ttr._seeds = [_jax_seed(k2)]
    tst = ttr.train_step()
    ttr.close()

    np.testing.assert_array_equal(tst.lengths, jres["lengths"])
    np.testing.assert_array_equal(tst.returns, jres["returns"])
    np.testing.assert_array_equal(tst.novelty, jres["novelty"])
    assert tst.novelty.dtype == np.float32 and len(tst.bc) == 2 * npairs
    ttheta = _check_update(tst, ttr, jtr, thetas[0], jres["returns"], jres["novelty"], idxs,
                           "centered_sign_rank", "nsr", lr)

    # the JAX package's eval rollout and mean BC replayed on a fresh engine:
    # its trajectories, and its mean BC of the port's updated parent
    jenv = JaxAtari("toy", **eng)
    _, jth = jes._make_antithetic(jnp.asarray(thetas[0]), jtr.noise.noise, k1, npairs, jnp.asarray(0.02))
    jth = jnp.concatenate([jth, jnp.broadcast_to(jth[-1:], (slots - 2 * npairs, D))])
    jr = j_rollout_host(jenv, jm.make_batch_act(), (jth, jm.batch_ref_stats(jth, jtr.ref_batch)), k1, cutoff,
                        collect_bc_traj=True)
    for b in range(2 * npairs):
        np.testing.assert_array_equal(tst.bc[b], jr.bc_traj[b])
        assert tst.bc[b].size == 128 * jr.lengths[b]
    jtr.env = jenv
    jnew = jtr._host_mean_bc(jnp.asarray(ttheta), k2, None)
    jenv.close()
    assert len(ttr.host_archive) == 3
    np.testing.assert_array_equal(ttr.host_archive[-1], jnew)
    for a, b in zip(ttr.host_archive[:2], archive):
        np.testing.assert_array_equal(a, b)
    _check_rows(quiet_loggers, 3)


# ---------------------------------------------------------- loader and CLI


def _exp(name):
    return json.loads((ROOT / "configurations" / name).read_text())


@pytest.mark.parametrize("name", ["maze_nses.json", "frostbite_nses.json", "frostbite_nsres.json"])
def test_ns_configurations_load_on_the_cpu(name, monkeypatch, quiet_loggers):
    """Each NS configuration builds an NSESTrainer with the JAX loader's
    fields (the JAX trainer stubbed out: only its config is read)."""
    seen = {}

    class Stub:
        def __init__(self, env, model, cfg, **kw):
            seen.update(env=env, model=model, cfg=cfg)

    monkeypatch.setattr(jnses, "NSESTrainer", Stub)
    small = {"noise_size": 3_000_000}
    jconfig.load_experiment(_exp(name), overrides={**small, "pod": False})
    jcfg = seen["cfg"]
    if getattr(seen["env"], "is_host_env", False):
        seen["env"].close()
    tr = tconfig.load_experiment(_exp(name), overrides=small, device="cpu")
    try:
        assert isinstance(tr, tnses.NSESTrainer)
        for f in ("population_size", "algo_type", "k", "meta_population_size", "num_rollouts", "selection_method",
                  "bc_mode", "noise_stdev", "l2coeff", "return_proc_mode", "episode_cutoff_mode"):
            assert getattr(tr.config, f) == getattr(jcfg, f), f
        assert tr.model.num_params == seen["model"].num_params
        assert len(tr.parents) == 3 and tr._archive_size() == 3 and tr.config.num_eval_episodes == 0
        if name == "maze_nses.json":
            assert isinstance(tr.env, tenvs.MazeEnv) and tr.model.num_params == 498 and tr.config.bc_mode == "final"
            assert tr._npairs_round() == 128 and tr.optimizer.stepsize == 0.01
        else:
            assert isinstance(tr.env, TorchAtari) and tr.env.episodic_life and tr.env.batch_size == 256
            assert isinstance(tr.model, tmodels.VirtualBNDQN) and tr.model.num_params == 1_004_852
            assert tr.config.bc_mode == "traj" and tr.cutoff.tslimit == 5000
            assert tr._npairs_round() == (50 if name == "frostbite_nses.json" else 128)
    finally:
        tr.close()


def test_ns_loader_rejections():
    with pytest.raises(NotImplementedError, match="MuJoCo"):
        tconfig.load_experiment(_exp("humanoid_nses.json"), overrides={"noise_size": 3_000_000}, device="cpu")
    with pytest.raises(ValueError, match="bc_mode"):  # an NS-only override
        tconfig.load_experiment(_exp("maze_es.json"), overrides={"bc_mode": "final"}, device="cpu")
    with pytest.raises(ValueError, match="host engines only"):
        tconfig.load_experiment(_exp("maze_nses.json"), overrides={"bc_mode": "traj", "noise_size": 3_000_000},
                                device="cpu")
    with pytest.raises(NotImplementedError, match="NS-ES runs CPU-stack files"):
        tconfig.load_experiment(_exp("es_atari_config.json"), overrides={"game": "toy"}, device="cpu", algo="nses")
    maze = _exp("maze_nses.json")
    with pytest.raises(NotImplementedError, match="quota mode"):  # ES on an NS file reads its quota
        tconfig.load_experiment(maze, overrides={"noise_size": 3_000_000}, device="cpu", algo="es")


def test_cli_trains_ns_on_the_cpu_and_needs_a_card_otherwise(quiet_loggers, monkeypatch):
    small = {"population_size": 16, "episode_cutoff_mode": 30, "noise_size": 3_000_000}
    argv = ["train", "--exp_file", str(ROOT / "configurations" / "maze_nses.json"), "--overrides", json.dumps(small),
            "--iterations", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    rows = quiet_loggers["torch"]
    assert len(rows) == 2 and set(NS_NAMES) <= set(rows[0])
    assert [r["ArchiveSize"] for r in rows] == [4, 5] and rows[0]["EpisodesThisIter"] == 16
    assert all(np.isfinite(r["EpNovMean"]) and r["EpNovMean"] > 0 for r in rows)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(argv) == 1
    with pytest.raises(NoCudaDevice):
        tconfig.load_experiment(_exp("maze_nses.json"), overrides=small)
