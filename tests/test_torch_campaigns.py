"""The port's learning-campaign scripts against the JAX package's, on the CPU.

scripts/run_maze_comparison_torch.py, scripts/parity_study_torch.py and
scripts/assemble_toy_curves_torch.py are the counterparts of the JAX
scripts of the same name without ``_torch``. Both sets are imported by
path. Tolerances:

* the maze eval: one 400-step episode of the same θ (from a numpy seed)
  through both scripts' ``make_eval``; the distance and the final (x, y)
  within 1e-4 (float32; sin and cos round otherwise in the last place).
  The episode runs free, so a last-place difference can grow: of the next
  θ of the same stream (scale 1.0), the packages' distances differ by
  0.29 after a wall contact. Step by step, with each JAX state fed in,
  the packages agree (tests/test_torch_device_envs.py);
* the assembler's ``load``, ``cutoff_bumps`` and ``significance``: equal
  to the JAX script's exactly, on one synthetic log holding a crashed
  launch, a restart and a resumed repeat; on an ES log (no Iteration
  column) the port keeps every generation where the JAX script keeps one;
* the parity verdict: the committed JAX artifact's finals give back its
  ``final_diff`` and ``welch_t`` within 1e-12 (the same float64 sums).

The JAX assemblers (``assemble_es``, ``assemble_ga``) are never called:
they write over the committed results/toy_*_r05.json.
"""

import importlib.util
import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.device import NoCudaDevice
from deep_neuroevolution_torch.utils import machine, tabular

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
PORT_SCRIPTS = ("run_maze_comparison_torch", "parity_study_torch", "assemble_toy_curves_torch")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_campaign_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


maze_t = _script("run_maze_comparison_torch")
parity_t = _script("parity_study_torch")
toy_t = _script("assemble_toy_curves_torch")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def table():
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    return NoiseTable.from_seed(count=3_000_000, device="cpu")


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_scripts_import_no_jax_and_default_to_cuda(name):
    """Each script imports torch, numpy and the port only; its ``--device``
    defaults to cuda, and nothing falls back to the CPU."""
    src = (SCRIPTS / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|deep_neuroevolution_tpu)\b", src, re.M)
    assert "deep_neuroevolution_tpu" not in src and "import jax" not in src
    assert re.search(r'"--device", default=None, help="cuda \(default\)', src)
    assert "except" not in src


def test_maze_eval_matches_jax():
    """One θ from a numpy seed through both scripts' ``make_eval``."""
    import jax

    maze_j = _script("run_maze_comparison")
    from deep_neuroevolution_torch.envs import MazeEnv
    from deep_neuroevolution_torch.models import ContinuousMLP

    env, model = MazeEnv(), ContinuousMLP(obs_dim=11, ac_dim=2)
    ev_t = maze_t.make_eval(env, model)
    ev_j = maze_j.make_eval(maze_j.MazeEnv(), maze_j.ContinuousMLP(obs_dim=11, ac_dim=2))
    rs = np.random.RandomState(5)
    for scale in (0.3, 1.0):
        theta = (scale * rs.randn(model.num_params)).astype(np.float32)
        ret_j, bc_j = ev_j(jax.numpy.asarray(theta), jax.random.PRNGKey(0))
        ret_t, bc_t = ev_t(torch.from_numpy(theta))
        assert abs(ret_t - float(ret_j)) <= 1e-4, (scale, ret_t, float(ret_j))
        np.testing.assert_allclose(bc_t, np.asarray(bc_j), rtol=0, atol=1e-4)
        assert ret_t < 0


def _write_log(d: Path, rows, bumps=True):
    d.mkdir(parents=True, exist_ok=True)
    with open(d / "metrics.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    lines = ["[2026-01-01 00:00:00.000] resuming from snapshot.pkl"]
    if bumps:
        lines += ["[2026-01-01 00:00:01.000] Increased timestep limit from 150 to 225",
                  "[2026-01-01 00:00:02.000] Increased timestep limit from 225 to 337"]
    (d / "log.txt").write_text("\n".join(lines) + "\n")


def _ga_row(it, launch):
    return {"Iteration": it, "PopulationEpRewMean": 0.4 + 0.01 * it + 0.001 * launch, "PopulationEpRewMax": 3.0,
            "PopulationEpCount": 256, "TimeElapsedThisIter": 10.0 + launch, "_launch": launch}


def test_assembler_load_bumps_and_significance_match_jax(tmp_path):
    """A crashed launch (generations 1-3), a restart at 1 that runs to 6,
    is resumed from its snapshot at 4 (4 and 5 logged again) and runs on
    to 8; two cutoff bumps in log.txt."""
    toy_j = _script("assemble_toy_curves")
    rows = [_ga_row(i, 0) for i in (1, 2, 3)] + [_ga_row(i, 1) for i in range(1, 7)]
    rows += [_ga_row(i, 2) for i in range(4, 9)]
    d = tmp_path / "ga_campaign"
    _write_log(d, rows)
    got, want = toy_t.load(str(d)), toy_j.load(str(d))
    assert got == want
    assert [r["Iteration"] for r in got] == list(range(1, 9))
    assert [r["_launch"] for r in got] == [1, 1, 1, 2, 2, 2, 2, 2]
    assert toy_t.cutoff_bumps(str(d)) == toy_j.cutoff_bumps(str(d))
    assert len(toy_t.cutoff_bumps(str(d))) == 2
    means = [r["PopulationEpRewMean"] for r in got]
    for args in ((sum(means[:5]) / 5, sum(means[-5:]) / 5, [m ** 0.5 for m in means], 256),
                 (0.38, 0.47, [0.5, 0.6, 0.55], 256), (0.4, 0.4, [], 0)):
        assert toy_t.significance(*args) == toy_j.significance(*args)


def test_assembler_keeps_every_es_generation(tmp_path):
    """The ES trainer logs no Iteration (in either package). The JAX
    script's ``load`` then keys every row by the missing column and gives
    back the last row alone; the port numbers ES rows by EpisodesSoFar:
    a restart (EpisodesSoFar = EpisodesThisIter) and a resumed repeat as
    for the GA."""
    toy_j = _script("assemble_toy_curves")

    def es_row(gen, launch):
        return {"EpRewMean": 0.3 + 0.01 * gen, "EpRewStd": 0.5, "EpisodesThisIter": 256,
                "EpisodesSoFar": 256 * gen, "EvalEpRewMean": float("nan"), "_launch": launch}

    rows = [es_row(i, 0) for i in (1, 2)] + [es_row(i, 1) for i in range(1, 5)] + [es_row(i, 2) for i in (3, 4, 5)]
    d = tmp_path / "es_campaign"
    _write_log(d, rows, bumps=False)
    got = toy_t.load(str(d))
    assert [r["EpisodesSoFar"] // 256 for r in got] == [1, 2, 3, 4, 5]
    assert [r["_launch"] for r in got] == [1, 1, 2, 2, 2]
    assert len(toy_j.load(str(d))) == 1  # the JAX script's reading of the same file
    art = toy_t.assemble_es(out=str(tmp_path / "es.json"), log_dir=str(d), device="cpu")
    assert art["generations"] == 5 and art["cutoff_bumps"] == []
    assert art["device"]["card"] == "cpu" and art["device"]["host_cores"] >= 1


def test_assembled_artifacts_keep_the_jax_keys(tmp_path):
    """Both assemblers on small logs: the JAX artifacts' keys plus
    ``device``; the assembler asks for a card unless told the CPU."""
    es_rows = [{"EpRewMean": 0.4, "EpRewStd": 0.5, "EpisodesThisIter": 16, "EpisodesSoFar": 16 * g,
                "EvalEpRewMean": 0.25, "EpLenMean": 30.0, "EvalPopRank": 0.5, "TimestepLimitPerEpisode": 150,
                "TimeElapsedThisIter": 1.0} for g in (1, 2, 3)]
    ga_rows = [_ga_row(i, 0) for i in (1, 2, 3)]
    for name, rows, fn in (("es", es_rows, toy_t.assemble_es), ("ga", ga_rows, toy_t.assemble_ga)):
        d = tmp_path / name
        _write_log(d, rows)
        art = fn(out=str(tmp_path / f"{name}.json"), log_dir=str(d), device="cpu")
        want = set(json.loads((ROOT / "results" / f"toy_{name}_curve_r05.json").read_text()))
        assert set(art) == want | {"device"}
        assert json.loads((tmp_path / f"{name}.json").read_text())["generations"] == 3
        assert art["cutoff_bumps"] == ["Increased timestep limit from 150 to 225",
                                       "Increased timestep limit from 225 to 337"]
        if not torch.cuda.is_available():
            with pytest.raises(NoCudaDevice):
                fn(out=str(tmp_path / f"{name}_cuda.json"), log_dir=str(d))


def test_parity_verdict_gives_back_the_jax_artifact():
    art = json.loads((ROOT / "results" / "parity_obstat.json").read_text())
    finals = [[c[-1] for c in art["arms"][name]["curves"]] for _, name in parity_t.ARMS]
    v = parity_t.verdict(*finals)
    for key in ("final_diff", "welch_t"):
        assert math.isclose(v[key], art["verdict"][key], rel_tol=1e-12, abs_tol=0), key
    assert v["within_seed_variance"] == art["verdict"]["within_seed_variance"]


def test_eval_count_leaves_theta_bit_identical():
    """θ after 3 CartPole generations is the same for eval counts 0 and 8
    (the eval seed is drawn either way, as the JAX package splits keval)."""
    assert parity_t.eval_bit_identity(device="cpu") is True


def test_parity_arm_on_the_maze():
    """One seed of each arm for 2 generations: eval returns finite and in
    [−diagonal, 0]; p = 1 counts every step of the 256 rollouts, p = 0.01
    a few rollouts' (eps 0.01 at the start)."""
    with tabular.quiet():
        for prob, _ in parity_t.ARMS:
            curve, count, secs = parity_t.run_arm(prob, seed=0, gens=1, device="cpu")
            assert len(curve) == len(secs) == 1 and all(-300 < c <= 0 for c in curve)
            if prob == 1.0:
                assert count == pytest.approx(256 * 400 + 0.01, rel=1e-6)
            else:
                assert 0.01 <= count < 256 * 400 * 0.1


def _diagonal():
    from deep_neuroevolution_torch.envs import MazeEnv

    segs = MazeEnv().cfg["segs"]
    return math.hypot(np.ptp(segs[:, [0, 2]]), np.ptp(segs[:, [1, 3]]))


def test_run_es_and_nses_keep_the_jax_keys(table, capsys):
    """ES and NS-ES at 16 members for 2 generations, an eval every one."""
    art = json.loads((ROOT / "results" / "maze_comparison.json").read_text())
    diag = _diagonal()
    with tabular.quiet():
        es = maze_t.run_es(table, 2, 1, print, population=16, device="cpu")
        ns = maze_t.run_nses(table, 2, 1, print, population=16, device="cpu")
    for got, key in ((es, "es"), (ns, "nses")):
        assert set(art[key]) <= set(got) and set(got) - set(art[key]) == {"s_per_gen"}
        assert len(got["parent_dist_curve"]) == 2 and got["population"] == 16
        for row in got["parent_dist_curve"]:
            assert set(row) == set(art[key]["parent_dist_curve"][0])
    dists = [es["best_offspring_dist"], es["final_parent_dist"], ns["best_offspring_dist"], *ns["final_parent_dists"]]
    assert all(math.isfinite(d) and 0 <= d <= diag for d in dists)
    assert len(ns["final_parent_dists"]) == 3 and ns["parent_dist_curve"][-1]["archive_size"] == 5
    assert es["generations"] == 2 and ns["iterations"] == 2
    assert "ES gen 2" in capsys.readouterr().out


def test_campaign_mains_ask_for_a_card(tmp_path):
    """Without ``--device cpu`` the mains need a card: NoCudaDevice here,
    before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod in (maze_t, parity_t):
        with pytest.raises(NoCudaDevice):
            mod.main(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_quiet_tabular_and_machine_description(tmp_path, capsys):
    """``tabular.quiet`` keeps a dump off stdout and in the log directory's
    files; ``machine.describe`` names the host."""
    tabular.start(str(tmp_path))
    try:
        with tabular.quiet():
            tabular.record_tabular("EpRewMean", 1.5)
            tabular.dump_tabular()
        tabular.record_tabular("EpRewMean", 2.5)
        tabular.dump_tabular()
    finally:
        tabular.stop()
    out = capsys.readouterr().out
    assert "1.5" not in out and "2.5" in out
    rows = [json.loads(ln) for ln in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["EpRewMean"] for r in rows] == [1.5, 2.5]
    d = machine.describe(torch.device("cpu"))
    assert d["card"] == "cpu" and d["host_cpu"] and d["host_cores"] >= 1
