"""The port's spans (utils/trace.py) on the CPU.

Off, ``span`` returns one shared no-op context and never reaches
``record_function``. Under ``torch.profiler`` the preprocessing and the
population forward of every DQN route mark their layers: ``preprocess.frames``
and ``preprocess.stack``; ``model.convs``, then ``model.fc`` or ``model.fused``,
then ``model.out``, and every operator of the forward lies inside exactly one
``model.*`` span. ``main train --profile_dir`` writes the trainers' spans into
its trace. No module of the port but utils/trace.py names ``record_function``.
"""

import gzip
import importlib.util
import json
import re
from pathlib import Path

import pytest
import torch

from deep_neuroevolution_torch import main as cli
from deep_neuroevolution_torch.envs.preprocess import preprocess_obs, stack_reset, stack_step
from deep_neuroevolution_torch.models import BNDQN, LargeDQN, SmallDQN, VirtualBNDQN
from deep_neuroevolution_torch.utils import tabular as ttab
from deep_neuroevolution_torch.utils import trace

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "deep_neuroevolution_torch"
B, ACTIONS = 3, 18
# route → (model, the spans its forward opens, in order)
ROUTES = {
    "vbn_split": (VirtualBNDQN(num_actions=ACTIONS), ("model.convs", "model.fc", "model.out")),
    "vbn_folded": (VirtualBNDQN(num_actions=ACTIONS, forward_impl="folded"), ("model.convs", "model.fc", "model.out")),
    "vbn_k4": (VirtualBNDQN(num_actions=ACTIONS, forward_impl="fused1"), ("model.convs", "model.fused", "model.out")),
    "vbn_k6": (VirtualBNDQN(num_actions=ACTIONS, forward_impl="fused"), ("model.convs", "model.fused", "model.out")),
    "bn_split": (BNDQN(num_actions=ACTIONS), ("model.convs", "model.fc", "model.out")),
    "small_split": (SmallDQN(num_actions=ACTIONS), ("model.convs", "model.fc", "model.out")),
    "small_k5": (SmallDQN(num_actions=ACTIONS, conv_impl="fused"), ("model.convs", "model.fc", "model.out")),
    "large_split": (LargeDQN(num_actions=ACTIONS), ("model.convs", "model.fc", "model.out")),
    "large_k3": (LargeDQN(num_actions=ACTIONS, forward_impl="fused"), ("model.convs", "model.fused", "model.out")),
}
# the trainers' and the host rollout's spans, by name (their readers depend on them)
TRAINER_SPANS = {"es.ref_stats", "es.rollout", "es.update", "es.eval", "ga.offspring", "ga.rollout", "ga.ladder",
                 "nses.novelty", "nses.rollout", "nses.mean_bc", "rollout.wait_actions", "rollout.engine",
                 "rollout.queue_forward", "rollout.upload", "rollout.forward"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(gen, mode):
    shape = (B, 84, 84) if mode == "preproc" else (B, 2, 210, 160)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)


def _act(route):
    """The route's act function on prepared members, and a stack of frames."""
    model, _ = ROUTES[route]
    gen = torch.Generator().manual_seed(3)
    thetas = torch.stack([model.init_theta(gen) for _ in range(B)])
    ctx = None
    if model.needs_ref_batch:
        ctx = model.batch_ref_stats(thetas, torch.rand((4, 84, 84, 4), generator=gen))
    act = model.make_batch_act()
    params = act.prepare((thetas, ctx))
    obs = torch.rand((B, 84, 84, 4), generator=gen)
    return act, params, obs


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _annotations(events, prefix):
    return [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith(prefix)]


def test_span_is_recorded_only_while_a_profiler_runs():
    assert not trace.recording()
    assert trace.span("model.convs") is trace.span("preprocess.frames")  # the one shared no-op
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.recording()
        assert isinstance(trace.span("model.convs"), torch.profiler.record_function)
    assert not trace.recording()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_no_record_function_without_a_profiler(route, monkeypatch):
    """Preprocessing, the stack and a route's act, with ``record_function``
    made to raise: off, no span reaches it."""
    act, params, obs = _act(route)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) called with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    gen = torch.Generator().manual_seed(0)
    stack = stack_reset(preprocess_obs(_frames(gen, "gray"), "gray"))
    stack = stack_step(stack, preprocess_obs(_frames(gen, "gray"), "gray"))
    want = act(params, obs)
    assert stack.shape == (B, 84, 84, 4) and want.shape == (B,)


@pytest.mark.parametrize("mode", ["gray", "indexed", "preproc"])
def test_preprocessing_spans(mode, tmp_path):
    gen = torch.Generator().manual_seed(1)
    stack = stack_reset(preprocess_obs(_frames(gen, mode), mode))
    frames = _frames(gen, mode)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        obs = preprocess_obs(frames, mode)
        stacked = stack_step(stack, obs)
        first = stack_reset(obs)
    events = _events(prof, tmp_path)
    assert [e["name"] for e in sorted(_annotations(events, "preprocess."), key=lambda e: float(e["ts"]))] == \
        ["preprocess.frames", "preprocess.stack", "preprocess.stack"]
    assert stacked.shape == first.shape == (B, 84, 84, 4)
    _assert_ops_inside(events, "preprocess.")


def _assert_ops_inside(events, prefix):
    """Every operator lies inside exactly one span named ``prefix…``."""
    spans = [_interval(e) for e in _annotations(events, prefix)]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    for e in ops:
        s, t = _interval(e)
        holders = [1 for a, b in spans if a <= s and t <= b]
        assert len(holders) == 1, (e["name"], len(holders))


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_spans(route, tmp_path):
    """A route's act under the profiler opens its layers' spans in order, and
    every operator of the forward lies inside one ``model.*`` span."""
    act, params, obs = _act(route)
    want = act(params, obs)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = act(params, obs)
    assert torch.equal(got, want)
    events = _events(prof, tmp_path)
    names = [e["name"] for e in sorted(_annotations(events, "model."), key=lambda e: float(e["ts"]))]
    # the out layer's span, then the argmax's (one span each where the kernel computes the out layer)
    assert tuple(dict.fromkeys(names)) == ROUTES[route][1]
    assert names.count("model.out") == (1 if "model.fused" in names else 2)
    _assert_ops_inside(events, "model.")


def test_population_step_nests_in_order(tmp_path):
    """One step of the population loop: preprocess, stack, forward, each
    span after the last, the LargeDQN on K3's route."""
    act, params, _ = _act("large_k3")
    gen = torch.Generator().manual_seed(2)
    stack = stack_reset(preprocess_obs(_frames(gen, "gray"), "gray"))
    frames = _frames(gen, "gray")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        stack = stack_step(stack, preprocess_obs(frames, "gray"))
        act(params, stack)
    spans = sorted(_annotations(_events(prof, tmp_path), ""), key=lambda e: float(e["ts"]))
    assert [e["name"] for e in spans] == ["preprocess.frames", "preprocess.stack", "model.convs", "model.fused",
                                         "model.out"]
    ends = [_interval(e) for e in spans]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


TOY = {"population_size": 8, "episode_cutoff_mode": 12, "noise_size": 3_000_000, "env_kwargs": {"batch_size": 4}}
TRAIN_CASES = {  # name → (experiment file, its fields changed, overrides, spans its trace holds)
    "es_toy": ("es_toy_config.json", {}, {**TOY, "num_eval_episodes": 2},
               {"es.ref_stats", "es.rollout", "es.update", "rollout.queue_forward", "preprocess.frames",
                "model.convs", "model.fc"}),
    "ga_toy": ("ga_toy_config.json", {"validation_threshold": 2, "num_validation_episodes": 2,
                                      "num_test_episodes": 2}, TOY,
               {"ga.offspring", "ga.rollout", "rollout.wait_actions", "rollout.queue_forward", "preprocess.stack",
                "model.out"}),
    "es_maze": ("maze_es.json", {}, {"population_size": 16, "episode_cutoff_mode": 30, "noise_size": 3_000_000},
                {"es.rollout", "es.update"}),
}


@pytest.mark.parametrize("name", sorted(TRAIN_CASES))
def test_profile_dir_writes_the_trainers_spans(name, tmp_path, monkeypatch):
    """``main train --profile_dir`` on the CPU: ``trace.json.gz`` and
    ``summary.txt``, the trace holding the trainer's spans, and on the host
    engine the rollout's, preprocessing's and forward's nested in them."""
    monkeypatch.setattr(ttab, "dump_tabular", lambda: ttab._logger._kvs.clear())
    path, fields, overrides, want = TRAIN_CASES[name]
    exp = {**json.loads((ROOT / "configurations" / path).read_text()), **fields}
    out = tmp_path / "prof"
    argv = ["train", "--exp_str", json.dumps(exp), "--overrides", json.dumps(overrides), "--device", "cpu",
            "--profile_dir", str(out)]
    assert cli.main(argv) == 0
    assert (out / "summary.txt").read_text().startswith("generation wall ")
    with gzip.open(out / "trace.json.gz", "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in events}
    assert want <= names, want - names
    assert not trace.recording()
    if "rollout.queue_forward" in want:  # the host engine: a step's forward is queued inside its group's span
        model_spans = [_interval(e) for e in events if e["name"].startswith("model.")]
        queued = [_interval(e) for e in events if e["name"] == "rollout.queue_forward"]
        assert any(a <= s and t <= b for s, t in model_spans for a, b in queued)


def test_only_the_helper_names_record_function():
    """The port's spans all go through utils/trace.py, and the trainers'
    and host rollout's span names are the documented ones."""
    named = sorted(str(p.relative_to(PACKAGE)) for p in PACKAGE.rglob("*.py") if "record_function" in p.read_text())
    assert named == ["utils/trace.py"]
    found = set()
    for p in (PACKAGE / "algos").glob("*.py"):
        found |= set(re.findall(r'\bspan\("([^"]+)"\)', p.read_text()))
    assert found == TRAINER_SPANS


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}}


def test_step_spans_reduces_by_the_innermost_program_span():
    """scripts/step_spans_torch.py on a synthetic trace of one step: each
    kernel goes to the program span open at its launch, each idle gap to
    the loop and program spans open at its middle."""
    spans = _load(ROOT / "scripts" / "step_spans_torch.py", "step_spans_torch")
    events = [_x("user_annotation", "bench.window", 0, 1000), _x("user_annotation", "bench.wait_actions", 2, 6),
              _x("user_annotation", "bench.preprocess", 10, 90), _x("user_annotation", "preprocess.frames", 15, 45),
              _x("user_annotation", "bench.forward", 110, 190), _x("user_annotation", "model.fc", 155, 95),
              _x("cpu_op", "aten::bmm", 18, 30)]
    for corr, (launch, start, dur) in enumerate([(5, 40, 10), (35, 100, 50), (40, 150, 50), (160, 260, 540)]):
        events += [_x("cuda_runtime", "cudaLaunchKernel", launch, 1, corr), _x("kernel", f"k{corr}", start, dur, corr)]
    got = spans.by_program_span(events, steps=2)
    assert got["device_ms"] == pytest.approx({"no program span": 5e-3, "preprocess.frames": 50e-3,
                                             "model.fc": 270e-3})
    assert got["device_ops"] == {"model.fc": 0.5, "no program span": 0.5, "preprocess.frames": 1.0}
    assert got["ops"]["preprocess.frames"] == [["k1", 0.5, pytest.approx(25e-3)], ["k2", 0.5, pytest.approx(25e-3)]]
    # gaps 0-40 (middle 20: the loop's preprocess, the program's frames), 50-100 (75: the loop's own), 200-260
    # (230: model.fc), 800-1000 (outside)
    assert got["idle_ms"] == pytest.approx({"program": 50e-3, "loop": 25e-3, "outside": 100e-3})
    assert dict(got["idle_gaps"])["bench.preprocess > preprocess.frames > aten::bmm"] == pytest.approx(20e-3)


def test_step_spans_runs_a_cell_on_the_cpu(monkeypatch, capsys):
    """The script end to end on the CPU, the cell cut to the harness tests'
    size: one JSON line, the loop's spans and the program's in one trace."""
    from nevobench import registry

    cells = _load(ROOT / "nevobench" / "tests" / "cells.py", "nevobench_test_cells")
    real = registry.cell
    monkeypatch.setattr(registry, "cell", lambda name: cells.shrink(real(name)))
    spans = _load(ROOT / "scripts" / "step_spans_torch.py", "step_spans_torch")
    assert spans.main(["--workload", "ga_atari.step_gray", "--seed", str(2**31 + 5), "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["device"] == "cpu" and got["steps"] == 3 and got["traced_step_ms"] > 0
    assert got["device_ms"] == {} and got["busy_ms"] == 0  # no device operations on the CPU
    assert set(got["idle_ms"]) == {"program", "loop", "outside"}
    assert sum(got["idle_ms"].values()) == pytest.approx(got["traced_step_ms"])  # the whole window idle
