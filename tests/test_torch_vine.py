"""The port's VINE dumps and TensorBoard events against the JAX package's,
on the CPU: for the same inputs the ``.dat`` files, the pickled reference
batch and the events file are the JAX package's byte for byte; an ES and a
GA generation with ``vine_snapshot_dir`` write their dumps, whose parent
policy file the JAX package reads."""

import time

import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import envs as tenvs
from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import es as tes
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.envs.atari import AtariEnv as TorchAtari
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_torch.utils import vine as tvine
from deep_neuroevolution_tpu.utils import checkpoint as jckpt
from deep_neuroevolution_tpu.utils import tabular as jtab
from deep_neuroevolution_tpu.utils import vine as jvine


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs a worker per core, and these small
    CPU forwards lose most of their time to threads waiting on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(base):
    return {p.relative_to(base).as_posix(): p.read_bytes() for p in sorted(base.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("iteration", [3, 12345])
def test_dat_files_match_jax(tmp_path, iteration):
    rs = np.random.RandomState(iteration)
    n, e, bc_dim = 6, 4, 3
    bcs = rs.randn(n, 2, bc_dim).astype(np.float32) * 100
    rets = rs.randn(n, 2).astype(np.float32)
    lens = rs.randint(1, 500, (n, 2)).astype(np.int32)
    idxs = rs.randint(0, 2**31 - 1, n).astype(np.int32)
    seeds = rs.randint(0, 2**31 - 1, n).astype(np.int32)
    ebcs, erets, elens = rs.randn(e, bc_dim).astype(np.float32), rs.randn(e).astype(np.float32) * 7, \
        rs.randint(1, 50, e).astype(np.int32)
    ref = rs.rand(2, 3).astype(np.float32)
    for pkg, base in ((jvine, tmp_path / "jax"), (tvine, tmp_path / "torch")):
        pkg.master_extract_cloud(str(base), iteration, bcs, rets, lens, idxs, seeds)
        pkg.master_extract_parent(str(base), iteration, ebcs, erets, elens, 0.02, ref_batch=ref, seed=17)
    j, t = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert len(j) == 3 and j == t
    # a [n, 2] seed column per rollout, as the port's host engine gives it
    tvine.master_extract_cloud(str(tmp_path / "pairs"), iteration, bcs, rets, lens, idxs,
                               np.stack([seeds, seeds + 1], axis=1))
    (rows,) = _files(tmp_path / "pairs").values()
    table = np.loadtxt(rows.decode().splitlines())
    assert table.shape == (2 * n, bc_dim + 5)
    np.testing.assert_array_equal(table[:, -2], np.stack([seeds, seeds + 1], axis=1).reshape(-1))
    np.testing.assert_array_equal(table[:, -1], np.tile([1.0, -1.0], n))


def test_events_files_match_jax(tmp_path, monkeypatch):
    """Both tabular loggers, at the same wall times, write the same
    events file (the version record, then one scalar event per dump; names
    and non-numbers as the reference drops them)."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    for pkg, d in ((jtab, tmp_path / "jax"), (ttab, tmp_path / "torch")):
        lg = pkg.TabularLogger(str(d))
        for step in range(3):
            for k, v in (("EpRewMean", 1.5 * step), ("EpisodesSoFar", 10 * step), ("Norm", np.float32(3.25)),
                         ("EvalEpRewMean", float("nan")), ("Name", "toy"), ("Done", True)):
                lg.record_tabular(k, v)
            lg.dump_tabular()
        lg.close()
    (jname, j), = ((k, v) for k, v in _files(tmp_path / "jax").items() if k.startswith("events.out.tfevents."))
    (tname, t), = ((k, v) for k, v in _files(tmp_path / "torch").items() if k.startswith("events.out.tfevents."))
    assert jname == tname and t == j and len(t) > 200


def test_es_generation_writes_vine_dumps(tmp_path):
    """One maze ES generation with ``vine_snapshot_dir``: a row per rollout
    (the maze's x-y, return, length, offset, the round's rollout seed,
    sign), the parent's row, and its policy file, which the JAX package
    loads to the new θ."""
    tr = tes.ESTrainer(tenvs.make("maze"), tmodels.ContinuousMLP(obs_dim=11, ac_dim=2),
                       tes.ESConfig(population_size=8, episode_cutoff_mode=20, num_eval_episodes=3,
                                    vine_snapshot_dir=str(tmp_path)),
                       noise_table=TorchNoise.from_seed(count=100_000, device="cpu"), device="cpu")
    st = tr.train_step()
    gen = tmp_path / "snapshots" / "snapshot_gen_0001"
    cloud = np.loadtxt(gen / "snapshot_offspring_0001.dat")
    assert cloud.shape == (8, 2 + 5)
    np.testing.assert_allclose(cloud[:, 2].reshape(4, 2), st.returns, rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(cloud[:, 3].reshape(4, 2), st.lengths)
    assert len(set(cloud[:, -2])) == 1  # one round: one rollout seed
    parent = np.loadtxt(gen / "snapshot_parent_0001.dat")
    assert parent.shape == (2 + 4,) and parent[3] in st.eval_lengths
    assert np.abs(st.eval_returns - parent[2]).min() <= 1e-6 * (1 + abs(parent[2]))
    _, theta, _ = jckpt.load_policy_snapshot(str(gen / "snapshot_parent_0001.h5"))
    assert np.array_equal(theta, tr.theta.numpy())


def test_ga_generation_writes_vine_dumps(tmp_path):
    """One GA generation on ToyCatch with ``vine_snapshot_dir``: a row per
    offspring in each of the two columns (the GA has no pairs), and the
    elite's test episodes as the parent."""
    env = TorchAtari("toy", batch_size=4, num_threads=1)
    try:
        tr = tga.GATrainer(env, tmodels.SmallDQN(num_actions=env.num_actions),
                           tga.GAConfig(population_size=4, selection_threshold=2, validation_threshold=2,
                                        num_validation_episodes=1, num_test_episodes=2, episode_cutoff_mode=8,
                                        vine_snapshot_dir=str(tmp_path)),
                           noise_table=TorchNoise.from_seed(count=3_000_000, device="cpu"), device="cpu")
        tr.train_step()
    finally:
        env.close()
    gen = tmp_path / "snapshots" / "snapshot_gen_0001"
    cloud = np.loadtxt(gen / "snapshot_offspring_0001.dat")
    assert cloud.shape == (8, 128 + 5)
    np.testing.assert_array_equal(cloud[0::2, :-1], cloud[1::2, :-1])
    assert sorted(cloud[0::2, -3].astype(np.int64)) == sorted(o.seeds[0] for o in tr.state.population)
    assert np.loadtxt(gen / "snapshot_parent_0001.dat").shape == (128 + 4,)
    _, theta, _ = jckpt.load_policy_snapshot(str(gen / "snapshot_parent_0001.h5"))
    assert torch.equal(torch.from_numpy(theta), tr._lookup_theta(tr.state.elite.seeds))
