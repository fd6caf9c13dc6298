"""Device time of the benchmark's population step by the program's own spans.

    python3 scripts/step_spans_torch.py --workload es_atari.step_gray --seed 7

From the root of a checkout, on the card. Sets a benchmark cell's loop up
(nevobench/: inputs from ``--seed``, the program, the warm-up), traces the
traffic's ``trace_steps`` steps with the harness's own ``tracing.capture``
(as a ``--trace 1`` run of nevobench/run.py does), and reduces the one
Chrome trace two ways:

* by the loop's ``bench.*`` spans (nevobench/tracing.py ``summarize``): the
  device ms a step under ``bench.preprocess`` and ``bench.forward``, which
  the benchmark reads as ``preprocess_ms`` and ``forward_ms``;
* by the program's spans (``preprocess.*``, ``model.*``:
  deep_neuroevolution_torch/utils/trace.py): device ms a step (the union of
  the operations launched inside each, the innermost span at the launch)
  and device operations a step, by span, and each span's operations by
  name; and each idle gap of the device by
  the loop span, the program span and the host operation open at its
  middle, summed as idle in the program, in the loop outside the program,
  and outside both.

Prints one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nevobench import tracing  # noqa: E402

NONE = "no program span"


def _finder(intervals):
    """``t`` → the name of the shortest of ``intervals`` holding it, or None."""
    intervals.sort()
    starts = [s for s, _, _ in intervals]
    longest = max((e - s for s, e, _ in intervals), default=0.0)
    return lambda t: tracing._innermost(intervals, starts, longest, t)


def by_program_span(events: list, steps: int) -> dict:
    """A Chrome trace's events (µs) reduced by the program's spans, a step."""
    launches, device, loop, program, host = {}, [], [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name, ts = e.get("cat", ""), e["name"], float(e["ts"])
        iv = (ts, ts + float(e.get("dur", 0.0)), name)
        corr = (e.get("args") or {}).get("correlation")
        if cat in tracing.DEVICE_CATS:
            device.append((iv[0], iv[1], corr, name))
        elif cat in tracing.LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        if cat == "user_annotation":
            if name == tracing.WINDOW:
                window = iv[:2]
            else:
                (loop if name.startswith("bench.") else program).append(iv)
        elif cat in tracing.HOST_CATS:
            host.append(iv)
    if window is None:
        raise RuntimeError(f"the trace has no {tracing.WINDOW} span")
    in_loop, in_program, in_host = _finder(loop), _finder(program), _finder(host)

    spans, ops, inside = collections.defaultdict(list), collections.defaultdict(list), []
    for s, e, corr, name in device:
        s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        inside.append((s, e))
        owner = (in_program(launches[corr]) if corr in launches else None) or NONE
        spans[owner].append((s * 1e-6, e * 1e-6))
        ops[owner, tracing._short(name)].append((e - s) * 1e-6)

    gaps, where, cursor = collections.Counter(), collections.Counter(), window[0]
    for s, e in sorted(inside) + [(window[1], window[1])]:
        if s > cursor:
            mid = (cursor + s) / 2
            keys = (in_loop(mid) or "no span", in_program(mid) or NONE, in_host(mid) or "idle host")
            gaps[" > ".join(keys)] += (s - cursor) * 1e-6
            where["program" if keys[1] != NONE else "loop" if keys[0] != "no span" else "outside"] += \
                (s - cursor) * 1e-6
        cursor = max(cursor, e)

    def ms(seconds):
        return 1e3 * seconds / steps

    top = sorted(ops.items(), key=lambda kv: -sum(kv[1]))
    return {
        "device_ms": {k: ms(tracing.union_s(v)) for k, v in sorted(spans.items())},
        "device_ops": {k: len(v) / steps for k, v in sorted(spans.items())},
        # by span, its operations by name: launches and device ms a step
        "ops": {k: [[n, len(v) / steps, ms(sum(v))] for (o, n), v in top if o == k] for k in sorted(spans)},
        "idle_ms": {k: ms(where[k]) for k in ("program", "loop", "outside")},
        "idle_gaps": [[k, ms(v)] for k, v in gaps.most_common(12)],
    }


def measure(workload: str, seed: int, device) -> dict:
    """Set the cell's loop up and trace its ``trace_steps`` steps."""
    import torch

    from nevobench import registry
    from nevobench.reference import common

    torch.set_num_threads(1)  # as nevobench/run.py
    common.use_exact_float32()
    device = torch.device(device)
    cell = registry.cell(workload)
    steps = cell.traffic["trace_steps"]
    run = cell.loop.Run(cell, seed, device)
    # capture returns only its summary: keep the events it reduces
    kept, summarize = [], tracing.summarize
    tracing.summarize = lambda events, n: kept.append(events) or summarize(events, n)
    try:
        summary = tracing.capture(run, steps, device)
    finally:
        tracing.summarize = summarize
        run.close()
    out = {"workload": workload, "seed": seed, "steps": steps,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "traced_step_ms": 1e3 * summary.window_s / steps, "busy_ms": 1e3 * summary.busy_s / steps,
           "loop_ms": {k: 1e3 * v / steps for k, v in sorted(summary.span_device_s.items())}}
    out.update(by_program_span(kept[0], steps))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
