"""The pod cases of the port's multi-process tests, and their worker.

Each case is an experiment file of configurations/, cut to a CPU size, run
for a few generations by a pod of two ranks: in one process as the
two-rank emulation (``build(name, emulate=True)``), or by two real gloo
ranks (``python tests/torch_pod_cases.py RANK WORLD STORE OUT_DIR``, which
runs every case and ``main train`` and writes each rank's results to
OUT_DIR). Imports torch and the port only.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOY = {"batch_size": 8, "num_threads": 1}
MAZE = {"population_size": 16, "episode_cutoff_mode": 30, "noise_size": 3_000_000}
# name → (experiment file, algo, overrides, generations)
CASES = {
    "host_es": ("es_atari_config.json", None, {"game": "toy", "population_size": 16, "episode_cutoff_mode": 20,
                                               "noise_size": 3_000_000, "env_kwargs": TOY,
                                               "num_eval_episodes": 3}, 2),
    "host_ga": ("ga_toy_config.json", None, {"population_size": 8, "episode_cutoff_mode": 10,
                                             "noise_size": 3_000_000,
                                             "env_kwargs": {"batch_size": 2, "num_threads": 1}}, 2),
    "host_rs": ("ga_toy_config.json", "rs", {"population_size": 8, "episode_cutoff_mode": 10,
                                             "noise_size": 3_000_000,
                                             "env_kwargs": {"batch_size": 2, "num_threads": 1}}, 2),
    "host_nses": ("frostbite_nses.json", None, {"population_size": 8, "episode_cutoff_mode": 20,
                                                "noise_size": 3_000_000, "env_kwargs": TOY}, 2),
    "device_es": ("maze_es.json", None, MAZE, 2),
    "device_es_quota": ("maze_es.json", None, {**MAZE, "episodes_per_batch": 16, "timesteps_per_batch": 100}, 2),
    "device_ga": ("maze_es.json", "ga", MAZE, 2),
    "device_nses": ("maze_nses.json", None, MAZE, 2),
}
try:  # the MuJoCo engine where gymnasium and mujoco import: humanoid.json in quota mode
    import gymnasium  # noqa: F401
    import mujoco  # noqa: F401

    # one global round of two 4-slot blocks a generation (8 episodes), so
    # the pod's obs sums add in the single trainer's order
    CASES["host_es_mujoco"] = ("humanoid.json", None, {
        "episode_cutoff_mode": 15, "episodes_per_batch": 8, "timesteps_per_batch": 8, "noise_size": 3_000_000,
        "num_eval_episodes": 2, "env_kwargs": {"batch_size": 4, "num_threads": 1}}, 2)
except ImportError:
    pass


def experiment(name: str) -> dict:
    exp = json.loads((ROOT / "configurations" / CASES[name][0]).read_text())
    if name in ("host_ga", "host_rs"):  # a ladder whose split is the single trainer's rounds
        exp = {**exp, "validation_threshold": 2, "num_validation_episodes": 2, "num_test_episodes": 4}
    if name == "host_es_mujoco":  # every other rollout into the obs stats (the file's 0.01 samples none of 8)
        exp = {**exp, "config": {**exp["config"], "calc_obstat_prob": 0.5}}
    return exp


def build(name: str, emulate: bool = False, single: bool = False):
    """The case's trainer on the CPU: the pod of this process's world, its
    two-rank emulation, or (``single``) the single-device trainer."""
    from deep_neuroevolution_torch.parallel import trainers as pt
    from deep_neuroevolution_torch.utils import config

    _, algo, overrides, _ = CASES[name]
    device_env = name.startswith("device")
    if single or (emulate and device_env):
        tr = config.load_experiment(experiment(name), overrides={**overrides, **({"pod": False} if device_env else {})},
                                    device="cpu", algo=algo)
        if single:
            return tr
        cls = {"ESTrainer": pt.PodESTrainer, "GATrainer": pt.PodGATrainer, "RSTrainer": pt.PodRSTrainer,
               "NSESTrainer": pt.PodNSESTrainer}[type(tr).__name__]
        kw = {"optimizer": tr.optimizer} if hasattr(tr, "optimizer") else {}
        return cls(tr.env, tr.model, tr.config, noise_table=tr.noise, device="cpu", emulate_procs=2, **kw)
    if emulate:
        overrides = {**overrides, "host_pod": 2}
    return config.load_experiment(experiment(name), overrides=overrides, device="cpu", algo=algo)


def run(tr, generations: int) -> list:
    """Each generation's results, as numpy."""
    out = []
    for _ in range(generations):
        st = tr.train_step()
        if hasattr(st, "population"):  # GA, RS
            out.append(dict(fitness=np.array([o.fitness for o in st.population]),
                            seeds=[o.seeds for o in st.population], elite=st.elite.seeds,
                            parents=tr.cached_parent_thetas.numpy() if tr.cached_parent_thetas is not None else None))
        else:
            rec = dict(returns=st.returns, lengths=st.lengths, theta=tr.theta.numpy().copy())
            if hasattr(st, "novelty"):
                rec.update(novelty=st.novelty, parent=st.parent, g=st.g.numpy(),
                           bc=np.concatenate([np.asarray(b).ravel() for b in st.bc]) if isinstance(st.bc, tuple)
                           else st.bc)
            else:
                rec.update(bc=st.bc, eval_returns=st.eval_returns, eval_lengths=st.eval_lengths)
            if tr.model.needs_ob_stat:
                rec.update({f"ob_{k}": v.cpu().numpy().copy() for k, v in zip(("sum", "sumsq", "count"), tr.ob_stat)})
            out.append(rec)
    return out


def quiet_tabular():
    from deep_neuroevolution_torch.utils import tabular

    tabular.dump_tabular = lambda: tabular._logger._kvs.clear()


def cli_argv(log_dir: str, iterations: int) -> list:
    """``main train`` of the host ES case, a trainer snapshot every
    generation."""
    exp, _, overrides, _ = CASES["host_es"]
    return ["train", "--device", "cpu", "--exp_file", str(ROOT / "configurations" / exp), "--iterations",
            str(iterations), "--snapshot_freq", "1", "--log_dir", log_dir, "--overrides", json.dumps(overrides)]


def worker(rank: int, world: int, store: str, out_dir: str) -> None:
    """One real rank: every case, then two ``main train`` runs (the second
    resumes the first's snapshot); rank 1 logs to a directory of its own in
    the first, to rank 0's in the second."""
    import torch.distributed as dist

    from deep_neuroevolution_torch import main
    from deep_neuroevolution_torch.parallel import distributed, mesh

    torch.set_num_threads(1)
    mesh.PopGroup.timed = True
    distributed.init_multihost(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                               device="cpu")
    from deep_neuroevolution_torch.utils import tabular

    out = Path(out_dir)
    results, dump = {}, tabular.dump_tabular
    for name, (_, _, _, gens) in CASES.items():
        quiet_tabular()
        tr = build(name)
        try:
            results[name] = dict(type=type(tr).__name__, runs=run(tr, gens), seconds=tr.pod.seconds,
                                 calls=tr.pod.calls)
        finally:
            tr.close()
    tabular.dump_tabular = dump
    for i in range(2):
        log_dir = out / ("cli_logs" if rank == 0 or i == 1 else f"cli_logs_rank{rank}")
        tr = main.cmd_train(main.build_parser().parse_args(cli_argv(str(log_dir), 1)))
        results[f"cli_{i}"] = tr.theta.numpy().copy()
        if i == 0 and rank == 0:
            shutil.copy(log_dir / "snapshot.pkl", out / "snapshot_gen1.pkl")
        dist.barrier()  # the snapshot is written before any rank resumes from it
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    os._exit(0)
