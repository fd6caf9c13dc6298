"""A hand-written kernel's share of its roofline in the traced window.

The least time a call could take is the larger of its bytes over the
card's HBM bandwidth and its FLOPs over the card's peak at the kernel's
precision (peaks.json); the configuration counts both from the shapes it
passes (each input byte read once, each output byte written once). The
share is that least time, times the calls, over the time every kernel of
the kernel's name took in the trace.
"""

from __future__ import annotations

from typing import Optional


def bound_s(kernel: dict, peaks: dict) -> float:
    return max(kernel["bytes"] / peaks["hbm_bytes_per_s"], kernel["flops"] / peaks["flops_per_s"][kernel["precision"]])


def bound_kind(kernel: dict, peaks: dict) -> str:
    """'bytes' or 'flops': which of the two bounds the kernel."""
    by_bytes = kernel["bytes"] / peaks["hbm_bytes_per_s"]
    return "bytes" if by_bytes >= kernel["flops"] / peaks["flops_per_s"][kernel["precision"]] else "flops"


def share(rec, kernel_id: str) -> Optional[float]:
    """Percent of the roofline of ``kernel_id`` (a key of the
    configuration's ``kernels``), or None where the cell has no such
    kernel or the trace holds none of its launches."""
    if rec.trace is None or rec.peaks is None:
        return None
    kernel = rec.cell.config_module.kernels(rec.cell.config, rec.group).get(kernel_id)
    if kernel is None:
        return None
    calls, _ = rec.trace.kernels(*kernel["launch_names"])
    _, seconds = rec.trace.kernels(*kernel["names"])
    if calls == 0 or seconds <= 0:
        return None
    return 100.0 * calls * bound_s(kernel, rec.peaks) / seconds
