"""Scaling study of the port's pods on the card.

The port's counterpart of scripts/scaling_study.py. The JAX script ran the
pod ES generation on virtual CPU meshes of 1/2/4/8 devices sharing the
host's cores; here the pod (``parallel/``) runs on torch.distributed gloo
worlds of 1/2/4/8 ranks, every rank a child process on the one card (as
chip_smoke.py phase 27 runs two), so the ranks share the card and the
host's cores. What is measured:

1. **Strong scaling (fixed total work).** ``PodESTrainer`` generations on
   the Hard Maze (``ContinuousMLP(hidden=16)``, a 2M-float table, σ 0.05,
   Adam 0.05, cutoff ``TSLIMIT``) of ``TOTAL_PAIRS`` pairs in all, split
   over N ranks; t(1)/t(N) is what the pod adds (the gathered columns,
   the summed partial gradients, the replicated update) plus the ranks'
   sharing of one card and of the host. Kernel K2 launches in every rank,
   once a generation (its partial sum).
2. **Weak scaling (fixed work a rank).** ``PAIRS_PER_DEV`` pairs a rank;
   on shared silicon the ideal t(N) is N·t(1), so efficiency_weak =
   N·t(1)/t(N).
3. **Host pods** (ToyCatch engine, SmallDQN with K1 for the fc, K2 in the
   update; ``HP_POP`` episodes on ``HP_BATCH`` slots, cutoff 30):
   a. ``HostPodESTrainer(..., emulate_procs=N)``, N = 1→8: the ranks run one
      after the other in one process, each on its own engine pool;
   b. the independent two-process baseline: two plain ``ESTrainer``s on
      half the population and half the slots each, no collectives;
   c. the real two-rank run: ``HostPodESTrainer`` in a gloo world of two,
      each rank on half the slots, ``PopGroup.timed`` on so that the
      collectives' seconds are kept (it syncs the card around each).
   (c − b) is what the pod fabric costs a generation, with the host's
   contention the same in both terms.
4. **Collective cost model**: the bytes a generation exchanges for three
   models (a [D] f32 gradient sum and O(pop) result columns), beside the
   collectives' seconds measured in (c).

Each point is the least of ``REPS`` windows of ``GENS_MEAS`` generations
after ``GENS_WARM`` (the host pods: ``HP_*``), every window kept in the
artifact. The defaults are the JAX script's. ``--preset smoke`` cuts the
run to 1 and 2 ranks with one window of one generation a point;
``--preset tiny`` also cuts the pairs, the cutoff and the host pods'
population and slots, for a run on the CPU (``PRESETS``; the children
take the same preset). With ``--device cpu`` the ranks run on the CPU: a
check of the control flow, not a measurement.

Output: ``--out`` (default results/scaling_torch.json), with the keys of
results/scaling_r05.json plus ``device`` (``utils/machine.py``).

Usage: python scripts/scaling_study_torch.py [--device cpu] [--out PATH] [--preset smoke|tiny]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.utils import machine  # noqa: E402

TOTAL_PAIRS = 1024  # strong scaling: antithetic pairs a generation, all ranks together
PAIRS_PER_DEV = 256  # weak scaling: pairs a rank
TSLIMIT = 200
GENS_WARM = 2
GENS_MEAS = 3  # generations per timing window
REPS = 5  # timing windows per point; the artifact keeps all, the headline is the least
HP_POP = 64  # host-pod episodes per generation
HP_BATCH = 16  # engine slots per (emulated) rank
HP_GENS_WARM, HP_GENS_MEAS, HP_REPS = 1, 3, 4
SIZES = (1, 2, 4, 8)  # ranks of the strong and weak series and of the emulation sweep
TABLE_COUNT = 2_000_000  # floats of each run's noise table
CHILD_TIMEOUT = 2400  # seconds a group of child processes may take
# (D, name) of the collective cost model: the VBN-DQN and the LargeDQN at 18
# actions, the humanoid MLP
COST_MODELS = ((1_008_450, "frostbite_es_vbn_dqn"), (4_052_658, "ga_atari_large_dqn"), (166_914, "humanoid_mlp"))
PRESETS = {  # --preset: module constants of a cut run
    "smoke": dict(SIZES=(1, 2), GENS_WARM=1, GENS_MEAS=1, REPS=1, HP_GENS_WARM=0, HP_GENS_MEAS=1, HP_REPS=1),
}
PRESETS["tiny"] = dict(PRESETS["smoke"], SIZES=(2,), TOTAL_PAIRS=16, PAIRS_PER_DEV=8, TSLIMIT=20, HP_POP=8, HP_BATCH=4)


def _windows(gen_fn, warm: int, meas: int, reps: int):
    """[reps] wall-clock windows of ``meas`` generations each, after ``warm``."""
    for _ in range(warm):
        gen_fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        frames = 0
        for _ in range(meas):
            frames += gen_fn()
        dt = time.perf_counter() - t0
        out.append({"s_per_gen": dt / meas, "frames_per_s": frames / dt})
    return out


def _launches() -> dict:
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
    from deep_neuroevolution_torch.ops.population_linear import population_linear

    return {"population_linear": population_linear.launches, "noise_gradient": noise_gradient.launches}


def _zero_launches() -> None:
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
    from deep_neuroevolution_torch.ops.population_linear import population_linear

    population_linear.launches = noise_gradient.launches = 0
    population_linear.bulk_launches = population_linear.general_launches = 0
    population_linear.launches_by_batch.clear()


def _join(device: torch.device, world: int, rank: int, store: str) -> None:
    from deep_neuroevolution_torch.parallel import distributed

    distributed.init_multihost(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                               device=device)


def _table(device: torch.device):
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    return NoiseTable.from_seed(count=TABLE_COUNT, device=device)


def _trainer_windows(tr, warm: int, meas: int, reps: int):
    """Windows of ``tr.train_step``; the rollouts' env steps count as the
    JAX script's "frames". Each rank's kernel launches over the windows."""
    def gen():
        st = tr.train_step()
        return int(np.asarray(st.lengths).sum())

    for _ in range(warm):
        gen()
    _zero_launches()
    pod = getattr(tr, "pod", None)
    if pod is not None:  # the collectives of the windows alone
        pod.seconds, pod.calls = 0.0, 0
    wins = _windows(gen, 0, meas, reps)
    return wins, _launches()


def _mesh_child(devices: int, weak: bool, rank: int, store: str, device: torch.device) -> dict:
    from deep_neuroevolution_torch.algos.es import ESConfig
    from deep_neuroevolution_torch.envs import MazeEnv
    from deep_neuroevolution_torch.models import ContinuousMLP
    from deep_neuroevolution_torch.ops import optim
    from deep_neuroevolution_torch.parallel.trainers import PodESTrainer

    _join(device, devices, rank, store)
    env, model = MazeEnv(), ContinuousMLP(obs_dim=11, ac_dim=2, hidden=16)
    pairs = PAIRS_PER_DEV * devices if weak else TOTAL_PAIRS
    cfg = ESConfig(noise_stdev=0.05, population_size=2 * pairs, num_eval_episodes=0, episode_cutoff_mode=TSLIMIT)
    tr = PodESTrainer(env, model, cfg, optimizer=optim.Adam(stepsize=0.05), noise_table=_table(device), seed=0,
                      device=device)
    if tr.pod.size != devices:
        raise RuntimeError(f"the pod has {tr.pod.size} ranks, not {devices}")
    wins, launches = _trainer_windows(tr, GENS_WARM, GENS_MEAS, REPS)
    return {"devices": devices, "ranks": devices, "cards": 1, "rank": rank, "weak": weak, "windows": wins,
            "s_per_gen": min(w["s_per_gen"] for w in wins), "launches": launches}


def _build_hostpod(emulate_procs, device: torch.device, batch=None):
    from deep_neuroevolution_torch.algos.es import ESConfig
    from deep_neuroevolution_torch.envs.atari import AtariEnv
    from deep_neuroevolution_torch.models import SmallDQN
    from deep_neuroevolution_torch.ops import optim
    from deep_neuroevolution_torch.parallel.host_pod import HostPodESTrainer

    env = AtariEnv("toy", batch_size=batch or HP_BATCH, num_threads=2, pipeline_groups=1)
    model = SmallDQN(num_actions=env.num_actions)
    cfg = ESConfig(noise_stdev=0.05, population_size=HP_POP, num_eval_episodes=2, episode_cutoff_mode=30)
    return HostPodESTrainer(env, model, cfg, optimizer=optim.Adam(stepsize=0.05), noise_table=_table(device),
                            seed=0, device=device, emulate_procs=emulate_procs)


def _hostpod_emu_child(procs: int, device: torch.device) -> dict:
    tr = _build_hostpod(procs, device)
    try:
        wins, launches = _trainer_windows(tr, HP_GENS_WARM, HP_GENS_MEAS, HP_REPS)
    finally:
        tr.close()
    return {"procs": procs, "windows": wins, "s_per_gen": min(w["s_per_gen"] for w in wins), "launches": launches}


def _hostpod_real_child(pid: int, nproc: int, store: str, device: torch.device) -> dict:
    from deep_neuroevolution_torch.parallel import mesh

    mesh.PopGroup.timed = True  # the collectives' seconds (a sync of the card around each)
    _join(device, nproc, pid, store)
    # each rank owns its share of slots: the work splits across the OS boundary
    tr = _build_hostpod(None, device, batch=HP_BATCH // nproc)
    try:
        wins, launches = _trainer_windows(tr, HP_GENS_WARM, HP_GENS_MEAS, HP_REPS)
        gens = HP_GENS_MEAS * HP_REPS
        coll_s, calls = tr.pod.seconds / gens, tr.pod.calls / gens
    finally:
        tr.close()
    return {"procs": nproc, "real": True, "rank": pid, "windows": wins, "s_per_gen": min(w["s_per_gen"] for w in wins),
            "collective_s_per_gen": coll_s, "collective_calls_per_gen": calls, "launches": launches}


def _hostpod_indep_child(share_pop: int, share_batch: int, num_threads: int, device: torch.device) -> dict:
    """One rank's share with no collectives and no pod trainer: a plain
    ESTrainer on its half of the population and slots. Two of these run at
    once, and the slower one's time is the no-fabric baseline."""
    from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer
    from deep_neuroevolution_torch.envs.atari import AtariEnv
    from deep_neuroevolution_torch.models import SmallDQN
    from deep_neuroevolution_torch.ops import optim

    env = AtariEnv("toy", batch_size=share_batch, num_threads=num_threads, pipeline_groups=1)
    cfg = ESConfig(noise_stdev=0.05, population_size=share_pop, num_eval_episodes=2, episode_cutoff_mode=30)
    tr = ESTrainer(env, SmallDQN(num_actions=env.num_actions), cfg, optimizer=optim.Adam(stepsize=0.05),
                   noise_table=_table(device), seed=0, device=device)
    try:
        wins, launches = _trainer_windows(tr, HP_GENS_WARM, HP_GENS_MEAS, HP_REPS)
    finally:
        tr.close()
    return {"windows": wins, "s_per_gen": min(w["s_per_gen"] for w in wins), "launches": launches}


# ------------------------------------------------------------------ driver

def _run_group(arg_lists, device: torch.device, preset) -> list:
    """Child processes of this script, started together (one a rank), each
    writing to its own log; the JSON each printed last, in order. Raises
    with the logs' tails if one fails."""
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                                                            "MASTER_PORT")}
    with tempfile.TemporaryDirectory(prefix="scaling_torch_") as work:
        store = str(Path(work) / "store")
        logs = [Path(work) / f"child{i}.log" for i in range(len(arg_lists))]
        procs = []
        try:
            for args, log in zip(arg_lists, logs):
                with open(log, "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.abspath(__file__), *args, "--store", store, "--device", str(device),
                         *(["--preset", preset] if preset else [])], env=env, stdout=f, stderr=subprocess.STDOUT,
                        text=True))
            for pr in procs:
                pr.wait(timeout=CHILD_TIMEOUT)
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
        texts = [log.read_text() for log in logs]
    if any(pr.returncode != 0 for pr in procs):
        raise RuntimeError("scaling study children failed:\n" + "\n".join(
            f"-- {' '.join(a)} (rc {pr.returncode})\n{t[-3000:]}" for a, pr, t in zip(arg_lists, procs, texts)))
    return [json.loads([ln for ln in t.splitlines() if ln.startswith("{")][-1]) for t in texts]


def _ranks(mode_args, n: int) -> list:
    return [[*mode_args, "--pid", str(r), "--nproc", str(n)] for r in range(n)]


def _mesh_point(n: int, weak: bool, device, preset) -> dict:
    outs = _run_group(_ranks(["--mode", "mesh", "--devices", str(n)] + (["--weak"] if weak else []), n), device,
                      preset)
    r = dict(outs[0])
    r.pop("rank")
    r["launches_by_rank"] = [o["launches"] for o in outs]
    r.pop("launches")
    return r


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="driver", choices=["driver", "mesh", "hostpod_emu", "hostpod_real",
                                                        "hostpod_indep"])
    p.add_argument("--devices", type=int, default=1, help="ranks of a mesh point")
    p.add_argument("--weak", action="store_true")
    p.add_argument("--procs", type=int, default=1)
    p.add_argument("--pid", type=int, default=0)
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--store", default=None, help="a child's file store for its gloo world")
    p.add_argument("--share_pop", type=int, default=None)
    p.add_argument("--share_batch", type=int, default=None)
    p.add_argument("--num_threads", type=int, default=1)
    p.add_argument("--preset", default=None, choices=sorted(PRESETS), help="a cut run (PRESETS)")
    p.add_argument("--out", default="results/scaling_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    preset = a.preset
    if preset:
        globals().update(PRESETS[preset])
    device = resolve_device(a.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    if a.mode != "driver":
        from deep_neuroevolution_torch.utils import tabular

        if device.type == "cpu":
            torch.set_num_threads(1)  # ranks that share the host's cores do not each take all of them

        with tabular.quiet():
            if a.mode == "mesh":
                res = _mesh_child(a.devices, a.weak, a.pid, a.store, device)
            elif a.mode == "hostpod_emu":
                res = _hostpod_emu_child(a.procs, device)
            elif a.mode == "hostpod_real":
                res = _hostpod_real_child(a.pid, a.nproc, a.store, device)
            else:
                res = _hostpod_indep_child(a.share_pop, a.share_batch, a.num_threads, device)
        print(json.dumps(res), flush=True)
        from deep_neuroevolution_torch.parallel import distributed

        distributed.shutdown()  # gloo's threads joined now: left to the interpreter's exit they can abort it
        return res

    results = {"config": {
        "mesh": {"total_pairs_strong": TOTAL_PAIRS, "pairs_per_device_weak": PAIRS_PER_DEV, "tslimit": TSLIMIT,
                 "gens_per_window": GENS_MEAS, "windows": REPS, "sizes": list(SIZES),
                 "estimator": "min over windows (noise-robust for fixed work)",
                 "workload": "maze PodESTrainer generation (fitness columns gathered, partial gradients summed) in "
                             "a gloo world of N ranks, each a process on the one card"},
        "hostpod": {"population": HP_POP, "batch": HP_BATCH, "windows": HP_REPS,
                    "workload": "toy-engine HostPodESTrainer generations (SmallDQN)"},
    }}

    mesh = {}
    for n in SIZES:
        mesh[str(n)] = r = _mesh_point(n, False, device, preset)
        print(f"mesh strong {n}: {r['s_per_gen']:.3f} s/gen (windows {[round(w['s_per_gen'], 3) for w in r['windows']]})",
              file=sys.stderr, flush=True)
    base = mesh[str(SIZES[0])]["s_per_gen"]
    for r in mesh.values():
        r["efficiency_vs_1dev"] = base / r["s_per_gen"]
    results["mesh_strong_scaling"] = mesh

    weak = {}
    for n in SIZES:
        weak[str(n)] = r = _mesh_point(n, True, device, preset)
        print(f"mesh weak {n}: {r['s_per_gen']:.3f} s/gen", file=sys.stderr, flush=True)
    wbase = weak[str(SIZES[0])]["s_per_gen"]
    for n, r in weak.items():
        r["efficiency_weak"] = int(n) * wbase / r["s_per_gen"]  # ideal on shared silicon: t(N) = N·t(1)
    results["mesh_weak_scaling"] = weak

    emu = {}
    for n in SIZES:
        emu[str(n)] = r = _run_group([["--mode", "hostpod_emu", "--procs", str(n)]], device, preset)[0]
        print(f"hostpod emu {n}: {r['s_per_gen']:.3f} s/gen", file=sys.stderr, flush=True)
    ebase = emu[str(SIZES[0])]["s_per_gen"]
    for r in emu.values():
        r["efficiency_vs_1proc"] = ebase / r["s_per_gen"]
    results["hostpod_emulation"] = emu

    share = ["--mode", "hostpod_indep", "--share_pop", str(HP_POP // 2), "--share_batch", str(HP_BATCH // 2),
             "--num_threads", "1"]
    ja, jb = _run_group([share, share], device, preset)
    indep = {"a": ja, "b": jb, "s_per_gen": max(ja["s_per_gen"], jb["s_per_gen"])}
    results["hostpod_indep_2proc"] = indep
    print(f"hostpod indep 2proc (no fabric): {indep['s_per_gen']:.3f} s/gen", file=sys.stderr, flush=True)

    outs = _run_group(_ranks(["--mode", "hostpod_real"], 2), device, preset)
    real = dict(outs[0])
    real.pop("rank")
    real["launches_by_rank"] = [o.pop("launches") for o in outs]
    real.pop("launches")
    real["collective_s_per_gen_by_rank"] = [o["collective_s_per_gen"] for o in outs]
    real["efficiency_vs_1proc_emulation"] = ebase / real["s_per_gen"]
    real["fabric_overhead_s_per_gen"] = real["s_per_gen"] - indep["s_per_gen"]
    real["fabric_overhead_frac"] = real["fabric_overhead_s_per_gen"] / real["s_per_gen"]
    results["hostpod_real_2proc"] = real
    print(f"hostpod real 2proc: {real['s_per_gen']:.3f} s/gen (fabric overhead {real['fabric_overhead_frac']:.1%}, "
          f"collectives {real['collective_s_per_gen']:.4f} s/gen)", file=sys.stderr, flush=True)

    card = machine.card(device)
    results["collective_cost_model"] = {name: {
        "gradient_psum_bytes": dim * 4,
        "result_columns_bytes_per_1000_eps": 1000 * (4 + 4 + 4 + 4),
        "measured_collective_s_per_gen": real["collective_s_per_gen"],
        "measured_collective_calls_per_gen": real["collective_calls_per_gen"],
        "measured_note": f"hostpod_real_2proc's collectives, measured (PopGroup.timed): two gloo ranks sharing "
                         f"{card}, the toy SmallDQN host pod's gathered columns and summed obs moments, not this "
                         "model's gradient; hostpod_real_2proc.fabric_overhead_s_per_gen is the whole fabric's cost",
    } for dim, name in COST_MODELS}

    n_hi = str(SIZES[-1])
    results["analysis"] = {
        "cores": os.cpu_count(),
        "card": card,
        "strong_scaling_reading": f"t({SIZES[0]})={base:.3f} -> t({n_hi})={mesh[n_hi]['s_per_gen']:.3f} s/gen at "
                                  f"{TOTAL_PAIRS} pairs in all, ranks sharing {card} and {os.cpu_count()} host "
                                  f"cores: efficiency {mesh[n_hi]['efficiency_vs_1dev']:.3f}",
        "weak_scaling_reading": f"{PAIRS_PER_DEV} pairs a rank: t({SIZES[0]})={wbase:.3f} -> "
                                f"t({n_hi})={weak[n_hi]['s_per_gen']:.3f} s/gen, N·t(1)/t(N) = "
                                f"{weak[n_hi]['efficiency_weak']:.3f} (ideal 1 when the ranks time-share the card)",
        "hostpod_reading": f"real two-rank {real['s_per_gen']:.3f} s/gen against the independent pair's "
                           f"{indep['s_per_gen']:.3f}: fabric overhead {real['fabric_overhead_frac']:.1%}, of it "
                           f"collectives {real['collective_s_per_gen']:.4f} s/gen; emulation {SIZES[0]}→{n_hi}: "
                           f"{ebase:.3f} -> {emu[n_hi]['s_per_gen']:.3f} s/gen",
    }
    results["device"] = machine.describe(device)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({
        "mesh_strong_eff": mesh[n_hi]["efficiency_vs_1dev"], "mesh_weak_eff": weak[n_hi]["efficiency_weak"],
        "hostpod_emu_eff": emu[n_hi]["efficiency_vs_1proc"],
        "hostpod_real_2proc_eff": real["efficiency_vs_1proc_emulation"],
        "hostpod_fabric_overhead_frac": real["fabric_overhead_frac"],
    }), flush=True)
    return results


if __name__ == "__main__":
    main()
