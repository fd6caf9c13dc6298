"""The readings that the limit of ``correct`` is set from, one JSON line a
seed, all seeds in one process:

    python3 nevobench/control.py --workload <name> --side program --seeds 1 2 3 --seconds 2
    python3 nevobench/control.py --workload <name> --side control --seeds 1 2 3 --seconds 2

``program``: the cell's loop as a run drives it, for ``--seconds`` after
set-up, then every action read back against the reference (the number a
run compares, ``gap_max``). ``control``: the same comparison of what the
next lower precision than the configuration's would answer, as the
configuration's ``check.control`` says: ``program_tf32`` runs the program
with TF32 products allowed (its own lower-precision path; the float32
configuration runs with them off), ``reference`` puts the reference in the
program's place with its rounding points at ``precision`` and takes its
argmax at every distinct stack. A control that passes the limit shows the
limit cannot tell the precisions apart.

The benchmark's runs do not run this. PERF.md gives the readings and the
limit set from them.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from nevobench import compare, registry  # noqa: E402
from nevobench.reference import common  # noqa: E402


def _summary(g: np.ndarray, limit: float) -> dict:
    nz = np.sort(g[g > 0])[::-1]
    return {"gap_max": float(g.max()), "nonzero": int(nz.size), "over_limit": int((g > limit).sum()),
            "top": [float(x) for x in nz[:5]], "decisions": int(g.size), "limit": limit}


def program_reading(workload: str, seed: int, seconds: float, device, tf32: bool = False) -> dict:
    """Gaps of the program's actions in a run of ``seconds`` (with TF32
    products allowed where ``tf32``)."""
    cell = registry.cell(workload)
    common.use_exact_float32()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        run = cell.loop.Run(cell, seed, torch.device(device))
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            run.step()
        run.drain()
        run.close()
    finally:
        common.use_exact_float32()
    n = len(run.actions)
    _, index = run.positions(n)
    g = compare.gaps(run.reference_scores(n), index, run.actions)
    return dict(_summary(g, cell.config["check"]["gap_limit"]), steps=n)


def reference_control(workload: str, seed: int, device, precision: str) -> dict:
    """Gaps of the reference's argmax at ``precision`` at every distinct
    stack a run's steps see."""
    cell = registry.cell(workload)
    common.use_exact_float32()
    run = cell.loop.Run(cell, seed, torch.device(device), program=False)
    n = run.R + 3  # every distinct stack: three with zero history, then one per ring entry
    order, _ = run.positions(n)
    ref = run.reference_scores(n)
    low = run.reference_scores(n, precision)
    g = compare.gaps(ref, np.arange(len(order)), low.argmax(dim=-1).numpy())
    return _summary(g, cell.config["check"]["gap_limit"])


def reading(workload: str, side: str, seed: int, seconds: float, device) -> dict:
    control = registry.load_json("configs", registry.load_json("workloads", workload)["config"])["check"]["control"]
    if side == "program":
        return program_reading(workload, seed, seconds, device)
    if control["kind"] == "program_tf32":
        return program_reading(workload, seed, seconds, device, tf32=True)
    if control["kind"] == "reference":
        return reference_control(workload, seed, device, control["precision"])
    raise ValueError(f"unknown control kind {control['kind']!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", choices=("program", "control"), required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        t = time.perf_counter()
        r = reading(args.workload, args.side, seed, args.seconds, args.device)
        print(json.dumps(dict(workload=args.workload, side=args.side, seed=seed, seconds=time.perf_counter() - t, **r)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
