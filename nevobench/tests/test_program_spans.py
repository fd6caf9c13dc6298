"""The trace reduction (tracing.py) on a trace that holds the program's own
spans (``preprocess.*``, ``model.*``: deep_neuroevolution_torch/utils/trace.py)
nested in the loop's ``bench.*`` spans. They are host events like any other:
every number the metrics read is what it is on the same trace without them,
and an idle gap inside a loop span names the program span open at its
middle where no operator is open there."""

import pytest

from cells import ROOT  # noqa: F401  (puts the checkout on sys.path)
from nevobench import tracing


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(op, ts, corr, kernel, start, dur):
    """An operator with one launch at ``ts`` and its kernel on the device."""
    return [_x("cpu_op", op, ts - 1, 3), _x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr),
            _x("kernel", kernel, start, dur, corr)]


def _trace():
    """One step in a window of 1000 µs: preprocess (three kernels, from 100 to
    230 µs), then the forward (four, from 260 to 830 µs with a gap at 810)."""
    events = [
        _x("user_annotation", tracing.WINDOW, 0, 1000),
        _x("user_annotation", "bench.preprocess", 10, 90),
        _x("cpu_op", "aten::select", 12, 2),  # the loop's ring index, outside the program's spans
        _x("user_annotation", "preprocess.frames", 20, 40),
        _x("user_annotation", "preprocess.stack", 65, 25),
        _x("user_annotation", "bench.forward", 110, 190),
        _x("user_annotation", "model.convs", 115, 35),
        _x("user_annotation", "model.fc", 155, 95),
        _x("user_annotation", "model.out", 255, 35),
    ]
    events += _launch("aten::max", 25, 1, "max_kernel", 100, 50)
    events += _launch("aten::bmm", 40, 2, "gemm_resize", 150, 50)
    events += _launch("aten::cat", 75, 3, "cat_kernel", 200, 30)
    events += _launch("aten::bmm", 120, 4, "gemm_conv", 260, 140)
    events += _launch("nevo::population_linear", 160, 5, "population_linear_bulk", 400, 400)
    events += _launch("aten::add", 262, 6, "add_kernel", 800, 10)
    events += _launch("aten::argmax", 280, 7, "argmax_kernel", 820, 10)
    return events


def _without_program_spans(events):
    return [e for e in events if e["cat"] != "user_annotation" or e["name"].startswith("bench.")]


def test_program_spans_leave_the_metrics_as_they_are():
    with_spans = tracing.summarize(_trace(), steps=1)
    without = tracing.summarize(_without_program_spans(_trace()), steps=1)
    assert with_spans.window_s == without.window_s == pytest.approx(1e-3)
    assert with_spans.busy_s == without.busy_s == pytest.approx(690e-6)
    assert with_spans.span_device_s == without.span_device_s
    assert with_spans.span_device_s == pytest.approx({"bench.preprocess": 130e-6, "bench.forward": 560e-6})
    assert with_spans.ops == without.ops
    assert sum(with_spans.idle_by_host.values()) == pytest.approx(sum(without.idle_by_host.values()))
    assert sum(with_spans.idle_by_host.values()) == pytest.approx(310e-6)


def test_an_idle_gap_names_the_program_span_open_at_its_middle():
    """Gaps at 0-100 µs (middle in preprocess.frames, between its operators),
    230-260 (in model.fc), 810-820 and 830-1000 (outside every span)."""
    idle = tracing.summarize(_trace(), steps=1).idle_by_host
    assert idle == pytest.approx({"bench.preprocess > preprocess.frames": 100e-6, "bench.forward > model.fc": 30e-6,
                                  "no span > idle host": 180e-6})
    bare = tracing.summarize(_without_program_spans(_trace()), steps=1).idle_by_host
    assert bare == pytest.approx({"bench.preprocess": 100e-6, "bench.forward": 30e-6, "no span > idle host": 180e-6})
