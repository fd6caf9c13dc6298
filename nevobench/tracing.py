"""The traced window: ``torch.profiler`` over a fixed number of steps, its
Chrome trace read back into sums the per-layer metrics take.

The loop opens the spans ``bench.<layer>`` from the benchmark's own code
around its calls into the program. A device operation belongs to the
innermost ``bench.*`` span open on the host when it was launched (kernel
and launch share the profiler's correlation id); the window is the span
``bench.window``, which ends after a device sync, so every operation of its
steps runs inside it.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class TraceSummary:
    steps: int  # loop steps inside the window
    window_s: float  # length of bench.window
    busy_s: float  # union of device operations inside it
    span_device_s: Dict[str, float]  # device seconds (union) of the operations each bench.* span launched
    ops: Dict[str, List[Tuple[float, float]]]  # device operation name → its (start, end) times, s
    idle_by_host: Dict[str, float]  # device idle seconds by what the host was doing

    def kernels(self, *parts: str) -> Tuple[int, float]:
        """Launches, and seconds in which any ran, of the device operations
        whose name holds any of ``parts``. A union and not a sum: a kernel
        launched early to wait on another (programmatic dependent launch)
        runs beside it."""
        found = [iv for name, ivs in self.ops.items() if any(p in name for p in parts) for iv in ivs]
        return len(found), union_s(found)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by name, summed) and
        the device's idle time by what the host was doing."""
        totals = {}
        for name, ivs in self.ops.items():
            key = _short(name)
            totals[key] = totals.get(key, 0.0) + sum(e - s for s, e in ivs)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cursor = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > cursor:
            total += e - max(s, cursor)
            cursor = e
    return total


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def _activities(device: torch.device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def capture(run, steps: int, device: torch.device, lead: int = 10) -> TraceSummary:
    """``steps`` steps of ``run`` under the profiler, with its spans on,
    after ``lead`` steps that let the profiler settle."""
    run.span = torch.profiler.record_function
    try:
        with torch.profiler.profile(activities=_activities(device)) as prof:
            for _ in range(lead):
                run.step()
            run.drain()
            with torch.profiler.record_function(WINDOW):
                for _ in range(steps):
                    run.step()
                run.drain()
    finally:
        run.span = nullspan
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, steps)


def nullspan(name: str):
    """The spans of an untraced step: nothing."""
    return contextlib.nullcontext()


def _innermost(intervals: List[Tuple[float, float, str]], starts: List[float], longest: float,
               t: float) -> Optional[str]:
    """The shortest interval of ``intervals`` (sorted by start, none longer
    than ``longest``) that holds ``t``."""
    best = None
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        s, e, name = intervals[i]
        if t - s > longest:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def summarize(events: list, steps: int) -> TraceSummary:
    """Reduce a Chrome trace's events (times in µs) to a ``TraceSummary``."""
    launches, device, spans, host = {}, [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e["name"], corr))
        if cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        if cat == "user_annotation" and e["name"] == WINDOW:
            window = (ts, ts + dur)
        elif cat == "user_annotation" and e["name"].startswith("bench."):
            spans.append((ts, ts + dur, e["name"]))
        if cat in HOST_CATS and e["name"] != WINDOW:
            host.append((ts, ts + dur, e["name"]))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    spans.sort()
    host.sort()
    span_starts, host_starts = [s[0] for s in spans], [h[0] for h in host]
    span_long = max((e - s for s, e, _ in spans), default=0.0)
    host_long = max((e - s for s, e, _ in host), default=0.0)

    by_span, ops, inside = collections.defaultdict(list), collections.defaultdict(list), []
    for s, e, name, corr in device:
        s, e = max(s, window[0]) * 1e-6, min(e, window[1]) * 1e-6
        if e <= s:
            continue
        inside.append((s, e))
        owner = _innermost(spans, span_starts, span_long, launches[corr]) if corr in launches else None
        by_span[owner or "unattributed"].append((s, e))
        ops[name].append((s, e))

    idle, cursor = collections.Counter(), window[0] * 1e-6
    for s, e in sorted(inside) + [(window[1] * 1e-6,) * 2]:
        if s > cursor:
            mid = (cursor + s) / 2 * 1e6
            span = _innermost(spans, span_starts, span_long, mid) or "no span"
            op = _innermost(host, host_starts, host_long, mid) or "idle host"
            idle[span if op == span else f"{span} > {op}"] += s - cursor
        cursor = max(cursor, e)
    span_s = {k: union_s(v) for k, v in by_span.items()}
    return TraceSummary(steps, (window[1] - window[0]) * 1e-6, union_s(inside), span_s, dict(ops), dict(idle))
