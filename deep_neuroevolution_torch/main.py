"""Command-line entry point of the port: ``train`` and ``replay``.

The counterpart of the JAX package's main.py ``cmd_train``:

    python -m deep_neuroevolution_torch.main train \\
        --exp_file configurations/es_atari_config.json --iterations 1 \\
        --overrides '{"game": "toy", "population_size": 512, "episode_cutoff_mode": 200}'
    python -m deep_neuroevolution_torch.main train --algo ga \\
        --exp_file configurations/ga_atari_config.json --iterations 2 \\
        --overrides '{"game": "toy", "population_size": 512, "episode_cutoff_mode": 200}'

    python -m deep_neuroevolution_torch.main train --exp_file configurations/maze_es.json
    python -m deep_neuroevolution_torch.main train --exp_file configurations/es_gym_config.json

    python -m deep_neuroevolution_torch.main train --exp_file configurations/maze_nses.json --iterations 3

    python -m deep_neuroevolution_torch.main train --exp_file configurations/frostbite_es.json \
        --log_dir logs/frostbite_es --iterations 0 --snapshot_freq 20
    python -m deep_neuroevolution_torch.train configurations/frostbite_es.json
    python -m deep_neuroevolution_torch.main train --exp_file configurations/frostbite_nses.json
    python -m deep_neuroevolution_torch.main train --exp_file configurations/frostbite_nsres.json

``--algo`` picks es, ga, rs or nses; without it a GPU-stack file with
"selection_threshold" runs the GA and any other file ES. A CPU-stack file
(``env_id``, ``policy``, ``config``; maze_es.json) runs ES, or NS-ES when
it has "novelty_search" (maze_nses.json, frostbite_nses.json and
frostbite_nsres.json, whose ``algo_type`` picks NS or NSR). maze_es.json,
es_gym_config.json and maze_nses.json run on the device envs (Hard Maze,
CartPole); the frostbite files on the ToyCatch engine with EpisodicLife.

frostbite_es.json runs ES in quota mode (5000 episodes and 10,000 steps a
generation).

It runs on the CUDA device unless ``--device cpu`` is given, and exits with
the "no CUDA device" error where there is none. Each generation prints the
reference's tabular row. ``--iterations`` generations run (default 1;
0 runs until the process is stopped, or a GA's timestep budget is spent).

Long runs (the JAX package's main.py:67-104): with ``--log_dir``, a run
resumes from ``<log_dir>/snapshot.pkl`` when it is there (``--no_resume``
starts afresh), and every ``--snapshot_freq`` generations (default 10;
0 never) writes that trainer snapshot and a policy file
``snapshot_iterNNNNN_rewR.pkl`` (utils/checkpoint.py), named by the
trainer's own generation count, which a resumed run carries on; the
trainer snapshot is written once more at the end. ``--exp_str`` takes the
experiment as JSON instead of ``--exp_file``. ``--profile_dir`` traces the
last generation with ``torch.profiler`` (with ``--iterations 0``, the
first); the program's spans (utils/trace.py) are recorded only then.

Several cards (the JAX package's pod launch, main.py:49): start one
process per card with torchrun; each rank runs the same command, the
loader picks the pod trainer (utils/config.py; parallel/), only rank 0
writes the log directory, snapshots and policy files, and the run ends by
logging each rank's digest of θ (a GA's population) and raising unless
they agree:

    python -m torch.distributed.run --nproc_per_node 2 -m deep_neuroevolution_torch.main train \
        --exp_file configurations/maze_es.json --iterations 10 --log_dir logs/maze_pod

Without torchrun a run is a world of one, as before.

``replay`` (the JAX package's main.py:108-146, 163-178) rolls a policy
file of either package (``--snapshot``) or a seed-chain elite (``--seeds``
with ``--model``, ``--model_kwargs``, ``--genome_style``, ``--noise_stdev``,
``--noise_count``) out for ``--episodes`` episodes on ``--env`` (default:
the file's, else the maze), writes the ``.npz`` of ``--save_frames`` and
prints one JSON line of stats (utils/viz.py):

    python -m deep_neuroevolution_torch.main replay --snapshot logs/snapshot_iter00010_rew5.pkl \
        --env toy --episodes 8 --env_kwargs '{"batch_size": 8}'
    python -m deep_neuroevolution_torch.main replay --seeds '[123, [456, 0.002]]' \
        --model LargeModel --model_kwargs '{"num_actions": 4}' --env toy --noise_count 25000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .device import NoCudaDevice


def cmd_train(args):
    """Run ``args.iterations`` generations (0: until stopped); returns the
    trainer, its engine closed. In a torchrun world only rank 0 writes, and
    the run ends by checking that every rank holds the same state."""
    from .parallel import distributed
    from .utils import tabular as tlogger

    joined = distributed.init_multihost(device=args.device)  # no-op without torchrun
    try:
        trainer = _train(args, distributed.is_coordinator())
        if distributed.process_count() > 1:
            what = f"{type(trainer).__name__} {'population' if _is_ga(trainer) else 'θ'}"
            digest = _state_digest(trainer)
            tlogger.log(f"rank {distributed.process_index()} of {distributed.process_count()}: {what} "
                        f"sha256 {digest}")
            distributed.check_replicated(digest, what)
        return trainer
    finally:
        if joined:
            distributed.shutdown()


def _state_digest(trainer) -> str:
    """A digest of the state every rank of a pod holds alike: θ, or the
    GA's population (seeds and fitness)."""
    import hashlib

    h = hashlib.sha256()
    if _is_ga(trainer):
        h.update(repr([(o.seeds, float(o.fitness)) for o in trainer.state.population]).encode())
    else:
        h.update(trainer.theta.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _train(args, writes: bool):
    from .utils import checkpoint, config, tabular as tlogger

    if args.exp_file:
        with open(args.exp_file) as f:
            exp = json.load(f)
    else:
        exp = json.loads(args.exp_str)
    if args.log_dir and writes:
        os.makedirs(args.log_dir, exist_ok=True)
        tlogger.start(args.log_dir)
    tlogger.log(f"experiment: {json.dumps(exp, sort_keys=True)}")
    overrides = json.loads(args.overrides) if args.overrides else {}
    trainer = config.load_experiment(exp, seed=args.seed, overrides=overrides, device=args.device, algo=args.algo)
    snap_path = os.path.join(args.log_dir, "snapshot.pkl") if args.log_dir else None
    try:
        if snap_path and os.path.exists(snap_path) and not args.no_resume:
            tlogger.log(f"resuming from {snap_path}")
            checkpoint.load_trainer(snap_path, trainer)
        done = 0
        while args.iterations == 0 or done < args.iterations:
            if _is_ga(trainer) and trainer.state.timesteps_so_far >= trainer.config.timesteps:
                break  # the GA's timestep budget is spent
            if writes and args.profile_dir and (done == args.iterations - 1 or args.iterations == 0 and done == 0):
                stats = profile_generation(trainer, args.profile_dir)
            else:
                stats = trainer.train_step()
            done += 1
            generation = _generations(trainer)
            if writes and snap_path and args.snapshot_freq and generation % args.snapshot_freq == 0:
                save_snapshots(trainer, args.log_dir, stats)
        if writes and snap_path:
            checkpoint.save_trainer(snap_path, trainer)
    finally:
        trainer.close()
        if args.log_dir and writes:
            tlogger.stop()
    return trainer


def _is_ga(trainer) -> bool:
    from .algos.ga import GATrainer

    return isinstance(trainer, GATrainer)


def _generations(trainer) -> int:
    """The generations a trainer has run, resumed ones included."""
    return trainer.state.it if _is_ga(trainer) else trainer.iteration


def save_snapshots(trainer, log_dir: str, stats):
    """The trainer snapshot ``<log_dir>/snapshot.pkl`` and a policy file whose
    reward is the generation's mean eval return, else its mean return (else
    a GA's elite fitness). Returns the policy file's path."""
    from .utils import checkpoint, tabular as tlogger

    path = os.path.join(log_dir, "snapshot.pkl")
    checkpoint.save_trainer(path, trainer)
    rew = None
    for name in ("eval_returns", "returns"):
        r = getattr(stats, name, None)
        if r is not None and np.size(r):
            rew = float(np.mean(r))
            break
    policy = checkpoint.save_policy_snapshot_auto(log_dir, trainer, _generations(trainer), rew)
    tlogger.log(f"saved snapshot to {path}" + (f" + {policy}" if policy else ""))
    return policy


def profile_generation(trainer, out_dir: str):
    """One generation under ``torch.profiler``: writes ``trace.json.gz`` (the
    timeline, with the program's spans: utils/trace.py) and ``summary.txt``
    (time by span and kernel, and the share of the generation's wall time
    the device ran kernels or copies). Returns the generation's stats."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if trainer.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stats = trainer.train_step()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json.gz"))
    events = prof.key_averages()
    # kernels and copies; the program's spans also show on the device
    # timeline and are left out, as the profiler's own table does
    device_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    )
    lines = [
        f"generation wall {wall:.3f} s; device busy {device_us / 1e6:.3f} s "
        f"({100 * device_us / 1e6 / wall:.1f}% of wall)",
        events.table(sort_by="cpu_time_total", row_limit=25),
        events.table(sort_by="self_device_time_total", row_limit=25),
    ]
    with open(os.path.join(out_dir, "summary.txt"), "w") as f:
        f.write("\n".join(lines))
    print(lines[0], flush=True)
    return stats


def cmd_replay(args) -> int:
    """Prints the replay's stats as one JSON line; 2 without a policy."""
    from .utils.viz import replay_seed_chain, replay_snapshot

    env_kwargs = json.loads(args.env_kwargs) if args.env_kwargs else None
    if args.seeds:
        noise_table = None
        if args.noise_count:
            from .device import resolve_device
            from .ops.noise import NoiseTable

            noise_table = NoiseTable.from_seed(count=args.noise_count, device=resolve_device(args.device))
        stats = replay_seed_chain(
            json.loads(args.seeds), model_name=args.model, env_id=args.env or "maze",
            model_kwargs=json.loads(args.model_kwargs) if args.model_kwargs else None,
            genome_style=args.genome_style, noise_stdev=args.noise_stdev, noise_table=noise_table,
            episodes=args.episodes, save_frames=args.save_frames, seed=args.seed, env_kwargs=env_kwargs,
            device=args.device,
        )
    else:
        if not args.snapshot:
            print("replay: provide --snapshot or --seeds", file=sys.stderr)
            return 2
        stats = replay_snapshot(args.snapshot, env_id=args.env, episodes=args.episodes, save_frames=args.save_frames,
                                seed=args.seed, env_kwargs=env_kwargs, device=args.device)
    print(json.dumps(stats), flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deep_neuroevolution_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="run an ES, GA, RS or NS-ES experiment (GPU-stack or CPU-stack JSON schema)")
    exp = t.add_mutually_exclusive_group(required=True)
    exp.add_argument("--exp_file", help="experiment JSON path")
    exp.add_argument("--exp_str", help="experiment JSON inline")
    t.add_argument("--algo", choices=["es", "ga", "rs", "nses"], help="algorithm (default: from the file)")
    t.add_argument("--log_dir", default="", help="log.txt, metrics.jsonl, TensorBoard events and snapshots go here")
    t.add_argument("--iterations", type=int, default=1, help="generations to run (0: until stopped)")
    t.add_argument("--snapshot_freq", type=int, default=10, help="trainer and policy snapshots every N generations")
    t.add_argument("--no_resume", action="store_true", help="ignore <log_dir>/snapshot.pkl")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--overrides", help='JSON, e.g. \'{"game": "toy", "population_size": 512}\'')
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--profile_dir", default="",
                   help="torch.profiler trace of the last generation → this dir (the program's spans are "
                        "recorded only while the profiler runs)")
    t.set_defaults(fn=cmd_train)

    r = sub.add_parser("replay", help="roll out a policy file or a seed-chain elite (scripts/viz.py, display.py)")
    r.add_argument("--snapshot", default=None, help="policy file of either package")
    r.add_argument("--env", default=None, help="env id (default: the file's, else maze)")
    r.add_argument("--episodes", type=int, default=1)
    r.add_argument("--save_frames", default="", help="write the returns, lengths and trajectory .npz here")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--env_kwargs", help='env JSON, e.g. \'{"batch_size": 8}\'')
    r.add_argument("--seeds", help='genome JSON, e.g. "[123, [456, 0.002]]" (gpu) or "[123, 456]" (cpu)')
    r.add_argument("--model", default="ContinuousMLP", help="model registry name for --seeds")
    r.add_argument("--model_kwargs", help="model constructor JSON for --seeds")
    r.add_argument("--genome_style", choices=["gpu", "cpu"], default="gpu")
    r.add_argument("--noise_stdev", type=float, default=0.002, help="a CPU-style chain's mutation stdev")
    r.add_argument("--noise_count", type=int, default=0, help="noise table size (0: the reference's 250M)")
    r.add_argument("--device", default=None, help="cuda (default) or cpu")
    r.set_defaults(fn=cmd_replay)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        rc = args.fn(args)
    except NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return rc if isinstance(rc, int) else 0  # train returns its trainer


if __name__ == "__main__":
    sys.exit(main())
