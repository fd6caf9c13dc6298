"""Command-line entry point of the port: ``train``.

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
    python -m deep_neuroevolution_torch.main train --exp_file configurations/frostbite_nses.json
    python -m deep_neuroevolution_torch.main train --exp_file configurations/frostbite_nsres.json

``--algo`` picks es, ga, rs or nses; without it a GPU-stack file with
"selection_threshold" runs the GA and any other file ES. A CPU-stack file
(``env_id``, ``policy``, ``config``; maze_es.json) runs ES, or NS-ES when
it has "novelty_search" (maze_nses.json, frostbite_nses.json and
frostbite_nsres.json, whose ``algo_type`` picks NS or NSR). maze_es.json,
es_gym_config.json and maze_nses.json run on the device envs (Hard Maze,
CartPole); the frostbite files on the ToyCatch engine with EpisodicLife.

It runs on the CUDA device unless ``--device cpu`` is given, and exits with
the "no CUDA device" error where there is none. Each generation prints the
reference's tabular row. ``--profile_dir`` traces the last generation with
``torch.profiler``. Not ported yet: snapshots and resume, ``replay``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .device import NoCudaDevice


def cmd_train(args):
    """Run ``args.iterations`` generations; returns the trainer, its engine
    closed."""
    from .utils import config, tabular as tlogger

    with open(args.exp_file) as f:
        exp = json.load(f)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        tlogger.start(args.log_dir)
    tlogger.log(f"experiment: {json.dumps(exp, sort_keys=True)}")
    overrides = json.loads(args.overrides) if args.overrides else {}
    trainer = config.load_experiment(exp, seed=args.seed, overrides=overrides, device=args.device, algo=args.algo)
    try:
        if args.profile_dir:
            trainer.train(args.iterations - 1)
            profile_generation(trainer, args.profile_dir)
        else:
            trainer.train(args.iterations)
    finally:
        trainer.close()
        if args.log_dir:
            tlogger.stop()
    return trainer


def profile_generation(trainer, out_dir: str) -> None:
    """One generation under ``torch.profiler``: writes ``trace.json.gz`` (the
    timeline) and ``summary.txt`` (time by span and kernel, and the share
    of the generation's wall time the device ran kernels or copies)."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if trainer.device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        trainer.train_step()
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json.gz"))
    events = prof.key_averages()
    # kernels and copies; spans of record_function also show on the device
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="deep_neuroevolution_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="run an ES, GA, RS or NS-ES experiment (GPU-stack or CPU-stack JSON schema)")
    t.add_argument("--exp_file", required=True, help="experiment JSON path")
    t.add_argument("--algo", choices=["es", "ga", "rs", "nses"], help="algorithm (default: from the file)")
    t.add_argument("--log_dir", default="", help="log.txt and metrics.jsonl go here")
    t.add_argument("--iterations", type=int, default=1, help="generations to run")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--overrides", help='JSON, e.g. \'{"game": "toy", "population_size": 512}\'')
    t.add_argument("--device", default=None, help="cuda (default) or cpu")
    t.add_argument("--profile_dir", default="", help="torch.profiler trace of the last generation → this dir")
    t.set_defaults(fn=cmd_train)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        args.fn(args)
    except NoCudaDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
