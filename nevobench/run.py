"""Run one cell of the benchmark of deep_neuroevolution_torch once.

    python3 nevobench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program. The run makes its
inputs from ``--seed``, builds or loads the program's kernels, warms up the
cell's shapes (all of it set-up), runs the cell's loop for ``--seconds``
with the device synced at the end, and then compares every answer the
loop read back with the plain reference (compare.py). ``--trace 1`` adds
a slice of ``trace_steps`` steps under ``torch.profiler`` after the
window and reports the cell's per-layer metrics in place of its
end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number compared beside its limit
(also the last lines of standard error). Without a CUDA device, with too
few of them, or with JAX loaded, it prints no result and exits non-zero.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".nevobench_cache"
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "deep_neuroevolution_tpu")


class NotRunnable(RuntimeError):
    """The run cannot give a result here (no card, or JAX loaded)."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t0: float = None) -> dict:
    """One run of ``workload`` on ``device``; the result object."""
    import torch

    from nevobench import registry, tracing
    from nevobench.record import Record
    from nevobench.reference import common

    t0 = _T0 if t0 is None else t0
    device = torch.device(device)
    torch.set_num_threads(1)  # the host's work is dispatch; no intra-op thread pool beside it
    common.use_exact_float32()
    cell = registry.cell(workload)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    run = cell.loop.Run(cell, seed, device)
    first = run.k
    phases = dict(run.setup_phases)
    setup_s = time.perf_counter() - t0
    gc.freeze()  # set-up's objects leave the collector's scans in the window

    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        run.step()
    run.drain()
    window_s = time.perf_counter() - t
    steps, member_steps, host_s = run.steps, run.member_steps, run.host_s

    summary = tracing.capture(run, cell.traffic["trace_steps"], device) if trace else None
    run.close()
    cards = range(cell.chips) if on_card else ()
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards), default=0)  # the fullest card
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    checks = run.check(first)
    del run
    found = forbidden_modules()
    if found:
        raise NotRunnable(f"modules of JAX or the JAX package are loaded: {found}")

    rec = Record(cell, setup_s, window_s, steps, member_steps, host_s, peak,
                 registry.peaks(name) if on_card else None, summary)
    readers = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m, mod in readers.items():
        value = mod.read(rec)
        if value is not None:
            metrics[m] = {"value": value, "unit": mod.UNIT}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cell.chips if on_card else 1,
           "memory_peak_bytes": peak}
    result = {"correct": checks["correct"], "attempted": checks["attempted"], "failed": checks["failed"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["setup_phases"] = phases
    result["checks"] = checks["checks"]
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        import torch

        import deep_neuroevolution_torch  # noqa: F401  (the system under test must be here)
    except ImportError as e:
        print(f"nevobench: cannot import the program: {e}", file=sys.stderr)
        return 2
    from nevobench import registry

    chips = int(registry.load_json("workloads", args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nevobench: the cell needs {chips} CUDA device(s), this machine has {n}", file=sys.stderr)
        return 2
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    except NotRunnable as e:
        print(f"nevobench: {e}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
