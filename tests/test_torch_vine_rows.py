"""What a VINE dump's row gives back when the inspector replays it, in the
port and, where it says so, in the JAX package (ROADMAP.md Queue 3). The
port writes the JAX package's dumps, and its inspector rebuilds a row's θ'
as the JAX package's does; these tests pin what that means.

* ES (``master_extract_parent`` after the update): generation g's parent
  file holds θ after generation g's update, while g's offspring were
  scored around θ before it, which is generation g−1's file. On the maze
  (every episode starts alike) a row of generation g replayed around
  g−1's θ gives back its recorded fitness within rtol 1e-6 (the dump's
  ten digits); around g's own file, the inspector's choice, it does not.
  The same holds in the JAX package.
* ES on the host engine: the ``policy_seed`` column is the rollout's
  engine episode seed, while a replay draws its round seed from it, so
  the replayed episode is another one even around the right θ.
* GA: each offspring is dumped twice, signs +1 and −1, around the elite's
  θ with the mutation power as σ. A +1 row's θ' is the offspring's θ plus
  (θ_elite − θ_parent), a −1 row's that minus 2·power·ε: the offspring's
  own θ only where its parent is the elite, and never for a −1 row.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch.algos import ga as tga
from deep_neuroevolution_torch.inspector import load_data, replay
from deep_neuroevolution_torch.inspector.interactive import Point
from deep_neuroevolution_torch.ops.noise import NoiseTable
from deep_neuroevolution_torch.utils import checkpoint, config, tabular, viz

ROOT = Path(__file__).resolve().parent.parent
ROWS = 8  # rows of generation 2 replayed


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    yield
    torch.set_num_threads(before)


def _points(path, gen, bc_dim, rows=ROWS):
    cloud = load_data.load_offspring(path, gen, bc_dim)
    out = []
    for i in range(rows):
        row = np.concatenate([cloud.bc[i], [cloud.fitness[i], cloud.length[i], cloud.noise_idx[i],
                                            cloud.policy_seed[i], cloud.sign[i]]])
        out.append(Point(gen, False, float(row[0]), float(row[1]), float(row[bc_dim]), row))
    return out


def _parent_file(path, gen):
    return os.path.join(path, "snapshots", f"snapshot_gen_{gen:04d}", f"snapshot_parent_{gen:04d}.h5")


def test_es_row_replays_its_fitness_around_the_previous_parent(tmp_path):
    """maze_es.json at 16 members, two generations: generation 2's rows
    replayed by ``replay_point`` (generation 2's file) against replayed
    around generation 1's θ (the θ they were scored around)."""
    exp = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    tr = config.load_experiment(exp, overrides={"population_size": 16, "noise_size": 3_000_000}, device="cpu")
    tr.config.vine_snapshot_dir = str(tmp_path)
    tr.train(2)
    _, theta1, _ = checkpoint.load_policy_snapshot(_parent_file(tmp_path, 1), "cpu")
    sigma = tr.config.noise_stdev
    fit, own, prev = [], [], []
    for pt in _points(str(tmp_path), 2, 2):
        fit.append(pt.fitness)
        own.append(replay.replay_point(str(tmp_path), pt, noise_table=tr.noise, device="cpu")["return_mean"])
        th = replay.perturbed_theta(theta1, tr.noise, int(pt.row[4]), float(pt.row[6]) * sigma)
        prev.append(viz.replay_snapshot(_parent_file(tmp_path, 1), seed=int(pt.row[5]), theta_override=th,
                                        device="cpu")["return_mean"])
    fit, own, prev = map(np.asarray, (fit, own, prev))
    np.testing.assert_allclose(prev, fit, rtol=1e-6)
    assert np.abs(own - fit).max() > 1.0  # measured: 66 (maze return units)


def test_es_row_replays_its_fitness_around_the_previous_parent_in_the_jax_package(tmp_path):
    """The same in the JAX package (its ``replay_point``, its files)."""
    from deep_neuroevolution_tpu.inspector import load_data as jload
    from deep_neuroevolution_tpu.inspector import replay as jreplay
    from deep_neuroevolution_tpu.utils import checkpoint as jckpt
    from deep_neuroevolution_tpu.utils import config as jconfig
    from deep_neuroevolution_tpu.utils import tabular as jtab
    from deep_neuroevolution_tpu.utils import viz as jviz

    jtab.dump_tabular = lambda: jtab._logger._kvs.clear()
    exp = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    tr = jconfig.load_experiment(exp, overrides={"population_size": 16, "noise_size": 3_000_000})
    tr.config.vine_snapshot_dir = str(tmp_path)
    tr.train(2)
    _, theta1, _ = jckpt.load_policy_snapshot(_parent_file(tmp_path, 1))
    cloud = jload.load_offspring(str(tmp_path), 2)
    fit, own, prev = [], [], []
    for i in range(ROWS):
        row = np.concatenate([cloud.bc[i], [cloud.fitness[i], cloud.length[i], cloud.noise_idx[i],
                                            cloud.policy_seed[i], cloud.sign[i]]])
        pt = Point(2, False, row[0], row[1], row[2], row)
        fit.append(row[2])
        own.append(jreplay.replay_point(str(tmp_path), pt, noise_table=tr.noise)["return_mean"])
        eps = np.asarray(tr.noise.get(int(row[4]), theta1.shape[0]))
        th = np.asarray(theta1) + row[6] * tr.config.noise_stdev * eps
        prev.append(jviz.replay_snapshot(_parent_file(tmp_path, 1), seed=int(row[5]), theta_override=th)["return_mean"])
    fit, own, prev = map(np.asarray, (fit, own, prev))
    np.testing.assert_allclose(prev, fit, rtol=1e-6)
    assert np.abs(own - fit).max() > 1.0  # measured: 23


def test_es_policy_seed_does_not_replay_the_host_engines_episode(tmp_path):
    """es_atari_config.json on ToyCatch (8 members, 8 slots, cutoff 200),
    two generations: four of generation 2's rows around generation 1's θ with the
    row's ``policy_seed`` as the replay's seed: another episode (lengths
    differ), where the maze's rows above give their fitness back."""
    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    env = {"batch_size": 8}
    tr = config.load_experiment(exp, overrides={"game": "toy", "population_size": 8, "episode_cutoff_mode": 200,
                                                "num_eval_episodes": 1, "noise_size": 3_000_000, "env_kwargs": env},
                                device="cpu")
    try:
        tr.config.vine_snapshot_dir = str(tmp_path)
        tr.train(2)
        bc_dim = tr.last_stats.bc.shape[-1]
        _, theta1, _ = checkpoint.load_policy_snapshot(_parent_file(tmp_path, 1), "cpu")
        lengths = []
        for pt in _points(str(tmp_path), 2, bc_dim, rows=4):
            th = replay.perturbed_theta(theta1, tr.noise, int(pt.row[bc_dim + 2]),
                                        float(pt.row[bc_dim + 4]) * tr.config.noise_stdev)
            r = viz.replay_snapshot(_parent_file(tmp_path, 1), env_id="toy", env_kwargs=env,
                                    seed=int(pt.row[bc_dim + 3]), theta_override=th, device="cpu")
            lengths.append((pt.row[bc_dim + 1], r["length_mean"]))
    finally:
        tr.close()
    lengths = np.asarray(lengths)
    assert (lengths[:, 0] != lengths[:, 1]).any(), lengths


def test_ga_rows_are_the_elites_theta_plus_sign_power_noise(tmp_path, monkeypatch):
    """A GPU-style GA on the maze (16 members, the ladder on, two
    generations): every dumped row's θ' against its offspring's θ rebuilt
    from the chain."""
    seen = []
    real = tga.GATrainer._selection_and_ladder

    def recorded(self, chains, *rest):
        seen.append(list(chains))
        return real(self, chains, *rest)

    monkeypatch.setattr(tga.GATrainer, "_selection_and_ladder", recorded)
    cfg = tga.GAConfig(population_size=16, selection_threshold=4, validation_threshold=4, num_validation_episodes=1,
                       num_test_episodes=1, mutation_power=0.05, episode_cutoff_mode=400,
                       vine_snapshot_dir=str(tmp_path))
    model = tmodels.ContinuousMLP(obs_dim=11, ac_dim=2)
    noise = NoiseTable.from_seed(count=3_000_000)
    tr = tga.GATrainer(config.resolve_env("maze"), model, cfg, noise_table=noise, device="cpu")
    tr.train(2)
    chains = seen[-1]
    parent = load_data.load_parent(str(tmp_path), 2)
    assert parent.extras[-1] == pytest.approx(0.05)  # the σ column holds the mutation power
    _, theta_elite, _ = checkpoint.load_policy_snapshot(_parent_file(tmp_path, 2), "cpu")
    np.testing.assert_array_equal(
        theta_elite.numpy(), checkpoint.theta_from_seed_chain(model, noise, tr.state.elite.seeds).numpy())
    cloud = load_data.load_offspring(str(tmp_path), 2)
    assert len(cloud.fitness) == 2 * len(chains) and (cloud.sign[::2] == 1).all() and (cloud.sign[1::2] == -1).all()
    for i, chain in enumerate(chains):
        theta = checkpoint.theta_from_seed_chain(model, noise, chain)
        theta_parent = checkpoint.theta_from_seed_chain(model, noise, chain[:-1])
        eps = noise.get(chain[-1][0], model.num_params)
        for k, sign in ((0, 1.0), (1, -1.0)):
            r = 2 * i + k
            assert cloud.noise_idx[r] == chain[-1][0] and cloud.fitness[r] == pytest.approx(cloud.fitness[2 * i])
            rebuilt = replay.perturbed_theta(theta_elite, noise, int(cloud.noise_idx[r]), sign * parent.extras[-1])
            want = theta + (theta_elite - theta_parent) - (1 - sign) * 0.05 * eps
            assert float((rebuilt - want).abs().max()) <= 1e-5
