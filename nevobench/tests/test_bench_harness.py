"""CPU dry runs of the benchmark harness at a tiny size: each cell's loop
end to end, the result line's schema, the FLOP and byte counts, cells
found from files alone, BENCHMARK.json against the files, and no JAX."""

import json
import math
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from cells import ROOT, WORKLOADS, small_cells  # noqa: F401  (a fixture)
from nevobench import registry, run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_end_to_end(small_cells, workload, trace):
    result = run.run_cell(workload, 2**31 + 17, 0.3, bool(trace), "cpu")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    check = result["checks"]["action_gap_max"]
    assert 0 <= check["value"] <= check["limit"]
    cell = registry.cell(workload)
    wanted = cell.per_layer if trace else cell.end_to_end
    for name, m in result["metrics"].items():
        assert name in wanted and m["unit"] == wanted[name].UNIT and math.isfinite(m["value"])
    if trace:
        assert "host_ms_per_step" in result["metrics"]
        assert {"busy_s", "window_s", "breakdown"} <= set(result["device"]) | set(result)
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"env_steps_per_s", "setup_s"} <= set(result["metrics"])
    json.dumps(result, allow_nan=False)


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_run_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and the harness gives no
    result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "nevobench", tmp_path / "nevobench", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "nevobench/run.py", "--workload", WORKLOADS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


VBN_FLOPS = 2 * (441 * 256 * 16 + 121 * 256 * 32 + 3872 * 256 + 256 * 18)
LARGE_FLOPS = 2 * (441 * 256 * 32 + 121 * 512 * 64 + 121 * 576 * 64 + 7744 * 512 + 512 * 18)


@pytest.mark.parametrize("config,flops,kernel,bytes_,kernel_flops", [
    # K1 on a group of 128: x [128, 3872], W [128, 3872, 256], y [128, 256], f32
    ("vbn_dqn_es", VBN_FLOPS, "K1", 4 * (128 * 3872 + 128 * 3872 * 256 + 128 * 256), 2 * 128 * 3872 * 256),
    # K3 on a group of 128: bf16 patches [441, 256] and weights (256·32, 512·64, 576·64, 64·121·512), f32 biases
    # (32 + 64 + 64 + 512), the f32 out layer padded to 64 lanes (512·64 + 64), the padded scores written (64)
    ("large_dqn_ga", LARGE_FLOPS, "K3",
     128 * (2 * (441 * 256 + 256 * 32 + 512 * 64 + 576 * 64 + 7744 * 512) + 4 * (672 + 512 * 64 + 64) + 4 * 64),
     128 * LARGE_FLOPS),
])
def test_flop_and_byte_counts(config, flops, kernel, bytes_, kernel_flops):
    cfg, mod = registry.load_json("configs", config), registry.load_module("configs", config)
    assert mod.forward_flops(cfg) == flops
    k = mod.kernels(cfg, 128)[kernel]
    assert (k["bytes"], k["flops"]) == (bytes_, kernel_flops)


@pytest.mark.parametrize("config", registry.names("configs", ".json"))
def test_reference_layout_is_the_programs(config):
    """The reference's flat θ layout has the configuration's parameter
    count, the program's model's, and its tensors in the program's order
    and shapes."""
    from deep_neuroevolution_torch.models import get_model

    from nevobench.reference import common

    cfg = registry.load_json("configs", config)
    ref = registry.load_module("reference", cfg["reference"]).layout(cfg)
    model = get_model(cfg["model"])(**cfg["model_kwargs"])
    assert common.total_dim(ref) == cfg["num_params"] == model.num_params
    assert [(n, tuple(s)) for n, s, _, _ in ref] == [(p.name, tuple(p.shape)) for p in model.specs]


def _run_copy(tmp_path, workload, shrink):
    """``run_cell(workload)`` on the CPU in a fresh process from the copy of
    the harness at ``tmp_path`` (its configuration cut by ``shrink``, keys
    set in the configuration); the result object."""
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from nevobench import registry, run\n"
            "real = registry.cell\n"
            "def small(n):\n"
            "    c = real(n); c.config = dict(c.config, **json.loads(sys.argv[4])); return c\n"
            "registry.cell = small\n"
            "r = run.run_cell(sys.argv[3], 5, 0.2, False, 'cpu')\n"
            "assert registry.HERE.parent == __import__('pathlib').Path(sys.argv[1])\n"
            "print(json.dumps(r))\n")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(ROOT), workload, json.dumps(shrink)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _copy_harness(tmp_path):
    shutil.copytree(ROOT / "nevobench", tmp_path / "nevobench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "nevobench"
    (bench / "metrics" / "steps_in_window.py").write_text('UNIT = "steps"\n\n\ndef read(rec):\n    return rec.steps\n')
    return bench


def test_cell_found_from_files_alone(tmp_path):
    """A new traffic mix, metric and cell added as files, and nothing else,
    run from a copy of the harness."""
    bench = _copy_harness(tmp_path)
    traffic = json.loads((bench / "traffic" / "step_gray.json").read_text())
    traffic.update(frame_ring=5, warmup_steps=1, trace_steps=2)
    (bench / "traffic" / "step_gray_tiny.json").write_text(json.dumps(traffic))
    (bench / "workloads" / "es_atari.tiny.json").write_text(json.dumps(
        {"config": "vbn_dqn_es", "traffic": "step_gray_tiny", "chips": 1, "end_to_end": ["steps_in_window"],
         "per_layer": []}))
    result = _run_copy(tmp_path, "es_atari.tiny", {"population_size": 4, "ref_batch_size": 8})
    assert result["correct"] and result["metrics"]["steps_in_window"]["value"] > 0
    assert list(result["checks"]) == ["action_gap_max"]


ROW_SUM_LOOP = '''
import numpy as np
import torch


class Run:
    """Each step sums the rows of a matrix made from the seed; the check
    compares every step's sums, and the count of steps answered."""

    def __init__(self, cell, seed, device):
        self.cfg, self.device = cell.config, device
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn(self.cfg["population_size"], self.cfg["width"], generator=gen, device=device)
        self.setup_phases, self.span, self.k = {}, None, 0
        self.steps = self.host_s = 0
        self.answers = []

    @property
    def member_steps(self):
        return self.steps * self.x.shape[0]

    def step(self):
        self.answers.append((self.x + self.steps % 3).sum(dim=1))
        self.steps += 1

    def drain(self):
        pass

    def close(self):
        self.answers = [a.double().cpu().numpy() for a in self.answers]

    def check(self, first):
        x, width = self.x.double().cpu().numpy().sum(axis=1), self.x.shape[1]
        err = max(float(np.abs(a - (x + width * (k % 3))).max()) for k, a in enumerate(self.answers))
        missing = self.steps - len(self.answers)
        lim = self.cfg["check"]
        ok = err <= lim["row_sum_err"] and missing <= lim["steps_missing"]
        return {"correct": ok, "attempted": len(self.answers) - first, "failed": 0 if ok else 1,
                "checks": {"row_sum_err": {"value": err, "limit": lim["row_sum_err"]},
                           "steps_missing": {"value": missing, "limit": lim["steps_missing"]}}}
'''


@pytest.mark.parametrize("limit,correct", [(1e-3, True), (0.0, False)])
def test_new_loop_found_from_files_alone(tmp_path, limit, correct):
    """A cell with a loop, configuration and checks of its own (no action
    gap, two numbers each against its own limit) added as files alone:
    the result's ``checks`` are the loop's."""
    bench = _copy_harness(tmp_path)
    (bench / "loops" / "row_sum.py").write_text(ROW_SUM_LOOP)
    (bench / "configs" / "rows.py").write_text("")
    (bench / "configs" / "rows.json").write_text(json.dumps(
        {"source": "a test", "population_size": 16, "width": 300, "check": {"row_sum_err": 1e-3, "steps_missing": 0}}))
    (bench / "traffic" / "rows_once.json").write_text(json.dumps({"loop": "row_sum", "trace_steps": 2}))
    (bench / "workloads" / "rows.sum.json").write_text(json.dumps(
        {"config": "rows", "traffic": "rows_once", "chips": 1, "end_to_end": ["steps_in_window"], "per_layer": []}))
    result = _run_copy(tmp_path, "rows.sum", {"check": {"row_sum_err": limit, "steps_missing": 0}})
    assert result["correct"] is correct and result["metrics"]["steps_in_window"]["value"] > 0
    assert list(result["checks"]) == ["row_sum_err", "steps_missing"]
    assert result["checks"]["row_sum_err"]["limit"] == limit and result["checks"]["steps_missing"]["value"] == 0


def test_run_takes_its_cards_from_the_workload(capsys, monkeypatch):
    """A cell whose workload file asks for more cards than the machine
    has gives no result."""
    real = registry.load_json
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(registry, "load_json",
                        lambda kind, name: dict(real(kind, name), chips=4) if kind == "workloads" else real(kind, name))
    rc = run.main(["--workload", WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "needs 4 CUDA" in out.err


def test_nothing_loads_jax(tmp_path):
    """Every module of the harness, a CPU run of each cell and the control
    script load no module named jax, jaxlib, flax or
    deep_neuroevolution_tpu (top-level names compared whole)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[1] + '/nevobench/tests')\n"
            "import cells\n"
            "from nevobench import registry, run, control\n"
            "real = registry.cell\n"
            "registry.cell = lambda n: cells.shrink(real(n))\n"
            "for w in cells.WORKLOADS:\n"
            "    run.run_cell(w, 3, 0.1, True, 'cpu')\n"
            "for kind in ('reference', 'loops', 'metrics', 'configs'):\n"
            "    for n in registry.names(kind, '.py'):\n"
            "        registry.load_module(kind, n)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "print(run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops, forbidden = proc.stdout.strip().splitlines()[-2:]
    assert forbidden == "[]" and "deep_neuroevolution_torch" in tops and "nevobench" in tops


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deep_neuroevolution_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxish", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "deep_neuroevolution_tpu.ops", types.ModuleType("x"))
    assert run.forbidden_modules() == ["deep_neuroevolution_tpu", "jax"]


def test_benchmark_json_matches_the_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    metrics = {m["name"]: m for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    for m in metrics.values():
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["unit"] == registry.load_module("metrics", m["name"]).UNIT
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert {c["name"] for c in BENCH["configs"]} == set(registry.names("configs", ".json"))
    for c in BENCH["configs"]:
        cfg = registry.load_json("configs", c["name"])
        assert c["file"] == f"nevobench/configs/{c['name']}.json" and c["source"] == cfg["source"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"]) and len(c["why"]) <= 200
    assert sorted(w["name"] for w in BENCH["workloads"]) == WORKLOADS
    for w in BENCH["workloads"]:
        f = registry.load_json("workloads", w["name"])
        assert (w["config"], w["traffic"], w["chips"]) == (f["config"], f["traffic"], f["chips"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert sorted(f["end_to_end"]) == sorted(m["name"] for m in BENCH["end_to_end"]
                                                 if w["name"] in m.get("workloads", [w["name"]]))
        assert sorted(f["per_layer"]) == sorted(m["name"] for m in BENCH["per_layer"]
                                                if w["name"] in m.get("workloads", [w["name"]]))
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and "\n" not in m["layer"]
