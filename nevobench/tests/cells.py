"""Shared by the harness's tests: its cells cut to a size the CPU runs in
seconds (4 members, a ring of 4 frames, a reference batch of 8), on the
kernels' plain versions. The widths stay the published ones."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from nevobench import registry  # noqa: E402

WORKLOADS = registry.names("workloads", ".json")


def shrink(cell):
    """``cell`` at the CPU's size. The LargeDQN takes K3's route
    (``forward_impl='fused'``), whose plain version on the CPU keeps K3's
    rounding points, as 'auto' does on the card."""
    cell.traffic = dict(cell.traffic, frame_ring=4, warmup_steps=2, trace_steps=3)
    cfg = dict(cell.config, population_size=4, ref_batch_size=8)
    if cfg["route_precision"] == "bfloat16":
        cfg["model_kwargs"] = dict(cfg["model_kwargs"], forward_impl="fused")
    cell.config = cfg
    return cell


@pytest.fixture
def small_cells(monkeypatch):
    """registry.cell, cut to the CPU's size."""
    real = registry.cell
    monkeypatch.setattr(registry, "cell", lambda name: shrink(real(name)))
    return registry.cell
