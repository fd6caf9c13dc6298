"""The port's VINE inspector (deep_neuroevolution_torch/inspector/) against
the JAX package's, on the CPU, on the same dumps: one set written with the
port's utils/vine.py from seeded numpy, read by both inspectors.

Tolerances, fixed before the comparisons:

* ``bin_offspring``, ``color_index``, ``gen_colors``, ``gen_marker``, the
  loaded data and the GUI's state after each call (artists' visibility,
  pickers, colors, marker sizes and data, annotations, titles, colorbar,
  slider, movie frames): equal;
* ``assemble``: equal arrays; ``disassemble`` and the 'two_end' and
  'downsampling' reductions: the written files byte for byte;
* 'pca': within 1e-9·max|ref| (float64) of the JAX package's scikit-learn
  ``PCA(n_components=2)`` at shapes where scikit-learn decomposes exactly
  ('full', 'covariance_eigh'), and at a shape where it takes its
  randomized solver on a spectrum that falls by half a column (its power
  iterations then converge to the exact decomposition the port computes);
* ``replay_point``'s θ': bit for bit; the replays' returns as
  tests/test_torch_replay.py holds them: the maze's whole 400-step
  episodes within rtol 1e-5 and the trajectories within 1e-2, ToyCatch's
  returns and lengths equal with the JAX round seeds fed in where the port
  draws its own (``viz._draw_seeds``).
"""

import os
import subprocess
import sys
from pathlib import Path

import matplotlib

matplotlib.use("Agg", force=True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from deep_neuroevolution_torch import NoCudaDevice  # noqa: E402
from deep_neuroevolution_torch import models as tmodels  # noqa: E402
from deep_neuroevolution_torch.inspector import interactive as ti  # noqa: E402
from deep_neuroevolution_torch.inspector import load_data as tload  # noqa: E402
from deep_neuroevolution_torch.inspector import plot as tplot  # noqa: E402
from deep_neuroevolution_torch.inspector import process_bc as tpbc  # noqa: E402
from deep_neuroevolution_torch.inspector import reduce as tred  # noqa: E402
from deep_neuroevolution_torch.inspector import replay as treplay  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise  # noqa: E402
from deep_neuroevolution_torch.utils import viz as tviz  # noqa: E402
from deep_neuroevolution_torch.utils.vine import master_extract_cloud, master_extract_parent  # noqa: E402
from deep_neuroevolution_tpu import models as jmodels  # noqa: E402
from deep_neuroevolution_tpu.inspector import interactive as ji  # noqa: E402
from deep_neuroevolution_tpu.inspector import load_data as jload  # noqa: E402
from deep_neuroevolution_tpu.inspector import reduce as jred  # noqa: E402
from deep_neuroevolution_tpu.inspector import replay as jreplay  # noqa: E402
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise  # noqa: E402
from deep_neuroevolution_tpu.utils import viz as jviz  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_OFFSPRING = 20  # antithetic pairs → 40 rows per generation
GENS = list(range(1, 7))
PCA_TOL = 1e-9  # × max|ref|


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _make_snapshots(base, gens=GENS, bc_dim=2, n=N_OFFSPRING, model=None, theta=None, ref_batch=None, seed=0):
    """The port's VINE dumps from seeded numpy (as tests/test_inspector_gui.py
    makes the JAX package's)."""
    rng = np.random.RandomState(seed)
    for gen in gens:
        master_extract_cloud(str(base), gen, rng.randn(n, 2, bc_dim) * 5, rng.rand(n, 2) * 100,
                             rng.randint(10, 50, (n, 2)).astype(float), rng.randint(0, 5000, n),
                             rng.randint(0, 2**31 - 1, n))
        master_extract_parent(str(base), gen, rng.randn(4, bc_dim), rng.rand(4) * 100,
                              rng.randint(10, 50, 4).astype(float), noise_stdev=0.05, model=model, theta=theta,
                              ref_batch=ref_batch, seed=gen)


@pytest.fixture(scope="module")
def snapdir(tmp_path_factory):
    base = tmp_path_factory.mktemp("vine")
    _make_snapshots(base)
    return str(base)


# ------------------------------------------------------------ helpers


def test_binning_and_colors_equal():
    rng = np.random.RandomState(3)
    for n, pfit in ((200, 30.0), (12, 0.5), (1, 2.0), (40, -5.0)):
        fit = np.sort(rng.rand(n) * 50)
        assert ti.bin_offspring(fit, pfit) == ji.bin_offspring(fit, pfit)
    for args in ((5.0, 5.0, 5.0), (10.0, 0.0, 10.0), (-1.0, 0.0, 10.0), (3.3, 0.0, 10.0), (7.1, 2.0, 9.0)):
        assert ti.color_index(*args) == ji.color_index(*args)
    for gen in range(25):
        assert ti.gen_colors(gen) == ji.gen_colors(gen) and ti.gen_marker(gen) == ji.gen_marker(gen)
    assert ti.NUM_BINS == ji.NUM_BINS and ti.TOP_SIZE == ji.TOP_SIZE


def test_load_data_equal(snapdir):
    assert tload.list_generations(snapdir) == jload.list_generations(snapdir) == GENS
    for gen in GENS:
        for a, b in ((tload.load_parent(snapdir, gen), jload.load_parent(snapdir, gen)),
                     (tload.load_offspring(snapdir, gen), jload.load_offspring(snapdir, gen))):
            assert type(a).__name__ == type(b).__name__ and a._fields == b._fields
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert np.asarray(x).dtype == np.asarray(y).dtype


# --------------------------------------------------------------- the GUI


def _artist(a):
    return (a.get_visible(), a.get_picker(), a.get_color(), a.get_marker(), a.get_markersize(),
            np.asarray(a.get_xydata()).tolist())


def _annot(a):
    return (a.get_visible(), a.get_text(), tuple(np.asarray(a.xy, float).tolist()))


def _gui_state(insp) -> dict:
    """Everything an Inspector shows, as plain values."""
    out = dict(gens=list(insp.gens), visible=sorted(insp.visible), mode=insp.cloud_mode, step=insp.step,
               max_visible=insp.max_visible, stochastic=insp.stochastic, save_movie=insp.save_movie)
    for k, cp in enumerate(insp.cloud_plots):
        for gen, ga in cp.gens.items():
            out[f"{k}.{gen}"] = dict(
                parent=_artist(ga.parent_artist), parent_xy=ga.parent_xy, fitness=ga.parent_fitness,
                table=ga.table.tolist(), bins=[(b.start, b.stop) for b in ga.bins], fit=(ga.minfit, ga.maxfit),
                annotation=None if ga.annotation is None else _annot(ga.annotation),
                artists=[_artist(a) for a in ga.bin_artists],
            )
        title = cp.fig._suptitle.get_text() if cp.fig._suptitle is not None else ""
        out[f"{k}.fig"] = dict(title=title, select=_annot(cp.select_annot), hover=_annot(cp.hover_annot),
                               cbar=cp.cbar_ax.get_visible(), trail=_artist(cp.trail),
                               xlim=tuple(cp.ax.get_xlim()), ylim=tuple(cp.ax.get_ylim()))
        if isinstance(cp, (ti.HiDimCloudPlot, ji.HiDimCloudPlot)):
            out[f"{k}.traj"] = _artist(cp.traj_line)
    fp = insp.fitness_plot
    out["fitness"] = dict(x=fp.x, y=fp.y, dot=_artist(fp.dot), title=fp.ax.get_title(), slider=fp.slider.val,
                          hover=_annot(fp.hover_annot),
                          markers={g: (_artist(p), _annot(a)) for g, (p, a) in sorted(fp._markers.items())})
    return out


def _movie_state(ani) -> list:
    return [[a.get_text() if hasattr(a, "get_text") else _artist(a) for a in frame] for frame in ani._framedata]


def _drive(insp, cp_point) -> list:
    """The widget callbacks' method calls, in order; the state after each."""
    states = []
    cp = insp.cloud_plots[0]
    steps = [
        lambda: insp.next(), lambda: insp.next(), lambda: insp.prev(), lambda: insp.set_visible_range(3),
        lambda: insp.next(), lambda: insp.next(), lambda: insp.next(), lambda: insp.toggle_gen(5),
        lambda: insp.toggle_gen(2), lambda: insp.set_cloud_mode("top"), lambda: insp.set_cloud_mode("none"),
        lambda: insp.set_cloud_mode("all"), lambda: insp.toggle_fast_pace(), lambda: insp.toggle_fast_pace(),
        lambda: insp.select_point(cp.point_from_row(*cp_point(cp))), lambda: insp.select_point(cp.parent_point(4)),
        lambda: insp.hover(4), lambda: insp.hover(None), lambda: insp.home(), lambda: insp.reset(),
        lambda: insp.prev(), lambda: insp.set_visible_range(1), lambda: insp.next(),
    ]
    for step in steps:
        step()
        states.append(_gui_state(insp))
    insp.step = 2
    states.append(_movie_state(insp.movie(cp)))
    insp.reset()
    states.append(_movie_state(insp.movie(cp)))
    insp.show(4)
    states.append(_movie_state(insp.movie(cp)))
    return states


def test_inspector_state_equal_after_each_call(snapdir):
    def point(cp):
        return 3, cp.gens[3].table[7]

    t = ti.Inspector([snapdir], interactive=False, visible_range=2)
    j = ji.Inspector([snapdir], interactive=False, visible_range=2)
    assert _gui_state(t) == _gui_state(j)
    for k, (a, b) in enumerate(zip(_drive(t, point), _drive(j, point))):
        assert a == b, f"state after call {k} differs"
    import matplotlib.pyplot as plt

    plt.close("all")


def test_hi_dim_inspector_state_equal(tmp_path):
    d = 8  # 4 x-coords + 4 y-coords per BC
    _make_snapshots(tmp_path, gens=(1, 2, 3), bc_dim=d, n=6, seed=1)
    kw = dict(bc_dim=d, hi_dim_bc=(str(tmp_path), d), interactive=False)
    t, j = ti.Inspector([str(tmp_path)], **kw), ji.Inspector([str(tmp_path)], **kw)
    for insp in (t, j):
        hd = insp.cloud_plots[-1]
        insp.next()
        insp.select_point(hd.point_from_row(1, hd.gens[1].table[0]))
    assert _gui_state(t) == _gui_state(j)
    assert len(t.cloud_plots[-1].traj_line.get_data()[0]) == d // 2
    import matplotlib.pyplot as plt

    plt.close("all")


def test_replay_callback_and_device(snapdir, monkeypatch):
    """The right-click replay reaches the injected callback as in the JAX
    GUI; the default one runs ``replay_point`` on the Inspector's device
    (None: cuda, so ``NoCudaDevice`` without a card)."""
    calls = []
    insp = ti.Inspector([snapdir], interactive=False, replay_fn=lambda path, pt, st: calls.append((path, pt, st)))
    cp = insp.cloud_plots[0]
    pt = cp.point_from_row(2, cp.gens[2].table[7])
    insp.replay(cp, pt)
    insp.stochastic = True
    insp.replay(cp, pt)
    assert [(c[0], c[1] is pt, c[2]) for c in calls] == [(snapdir, True, False), (snapdir, True, True)]
    seen = {}
    monkeypatch.setattr(treplay, "replay_point", lambda path, pt, **kw: seen.update(kw) or {
        "return_mean": 1.0, "length_mean": 2.0, "seed": 3, "bc_trajectory": np.zeros((4, 1, 2))})
    for device in (None, "cpu"):
        insp = ti.Inspector([snapdir], interactive=False, device=device)
        insp.replay(insp.cloud_plots[0], pt)
        assert seen["device"] == device
    monkeypatch.undo()  # the real replay_point: no card → NoCudaDevice, before any file is read
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    insp = ti.Inspector([snapdir], interactive=False)
    with pytest.raises(NoCudaDevice):
        insp.replay(insp.cloud_plots[0], pt)
    import matplotlib.pyplot as plt

    plt.close("all")


def test_gui_main_flags(snapdir):
    insp = ti.main([str(GENS[0]), str(GENS[-1]), snapdir, "--visible_range", "2", "--device", "cpu"])
    assert isinstance(insp, ti.Inspector) and insp.max_visible == 2 and insp.interactive is False
    assert insp.device == "cpu"
    assert ti.main([str(GENS[1]), str(GENS[2]), snapdir]).device == "cuda"
    import matplotlib.pyplot as plt

    plt.close("all")


# --------------------------------------------------------- the reduction


def _tree(root) -> dict:
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.dat"))}


@pytest.fixture(scope="module")
def hidim(tmp_path_factory):
    base = tmp_path_factory.mktemp("hidim")
    _make_snapshots(base, gens=(1, 2, 3), bc_dim=8, n=12, seed=2)
    return str(base)


@pytest.mark.parametrize("ds_ratio", [1.0, 0.5])
def test_assemble_and_disassemble_byte_equal(hidim, tmp_path, ds_ratio):
    t = tred.assemble(1, 3, hidim, bc_dim=8, ds_ratio=ds_ratio)
    j = jred.assemble(1, 3, hidim, bc_dim=8, ds_ratio=ds_ratio)
    for a, b in zip(t, j):
        if isinstance(a, list):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            np.testing.assert_array_equal(a, b)
    X, p_opt, ch_opt, num_os, _ = t
    X_r = np.random.RandomState(0).randn(X.shape[0], 2)
    kw = dict(start_iter=1, end_iter=3, chunk=1 + num_os)
    out_t = tred.disassemble(X_r, p_opt, ch_opt, "m", path=str(tmp_path / "t"), **kw)
    out_j = jred.disassemble(X_r, p_opt, ch_opt, "m", path=str(tmp_path / "j"), **kw)
    assert out_t.endswith("t_m") and _tree(out_t) == _tree(out_j) and len(_tree(out_t)) == 6


@pytest.mark.parametrize("method", ["two_end", "downsampling"])
def test_exact_methods_byte_equal(hidim, tmp_path, method):
    """``process`` through 'two_end' and 'downsampling' writes the JAX
    package's files byte for byte (the JAX reduce_dim imports scikit-learn
    for every method; the port's only for 'tsne' and 'lda')."""
    from deep_neuroevolution_tpu.inspector import process_bc as jpbc

    import shutil

    for name in ("t", "j"):
        shutil.copytree(hidim, tmp_path / name)
    out_t = tpbc.process(1, 3, str(tmp_path / "t"), 8, method=method)
    out_j = jpbc.process(1, 3, str(tmp_path / "j"), 8, method=method)
    assert _tree(out_t) == _tree(out_j)


# (rows, columns, spectrum falling by half a column): scikit-learn's solver
PCA_CASES = [(39, 8, False, "full"), (120, 64, False, "full"), (300, 16, False, "covariance_eigh"),
             (1026, 128, True, "randomized"), (700, 40, True, "covariance_eigh")]


@pytest.mark.parametrize("n,d,falling,solver", PCA_CASES)
def test_pca_matches_sklearn(n, d, falling, solver):
    rng = np.random.RandomState(n + d)
    X = rng.randn(n, d)
    if falling:
        X = (X * 0.5 ** np.arange(d)) @ np.linalg.qr(rng.randn(d, d))[0]
    X = X / np.abs(X).max()
    assert tred.pca_solver(n, d) == solver
    ref = jred.reduce_dim(X, labels=np.zeros(n), method="pca")
    got = tred.reduce_dim(X, labels=np.zeros(n), method="pca", device="cpu")
    assert got.dtype == np.float64 and got.shape == ref.shape == (n, 2)
    err = float(np.abs(got - ref).max())
    assert err <= PCA_TOL * float(np.abs(ref).max()), err
    # the signs: each component's largest loading positive, as svd_flip leaves it
    comps = np.linalg.lstsq(X - X.mean(0), got, rcond=None)[0].T
    assert all(c[np.abs(c).argmax()] > 0 for c in comps)


def test_pca_at_a_randomized_shape_is_the_exact_decomposition():
    """On a flat spectrum at a shape where scikit-learn takes its randomized
    solver, the JAX package's 'pca' depends on numpy's global generator and
    lands far from the principal components (ROADMAP.md Queue 3); the
    port's is the exact decomposition, the same on every call."""
    rng = np.random.RandomState(5)
    X = rng.randn(1026, 128)
    got = tred.pca(X, "cpu")
    u, s, vt = np.linalg.svd(X - X.mean(0), full_matrices=False)
    signs = np.sign(vt[np.arange(2), np.abs(vt[:2]).argmax(1)])
    exact = u[:, :2] * signs * s[:2]
    assert float(np.abs(got - exact).max()) <= PCA_TOL * float(np.abs(exact).max())
    np.testing.assert_array_equal(got, tred.pca(X, "cpu"))
    np.random.seed(0)
    ref = jred.reduce_dim(X, labels=np.zeros(len(X)), method="pca")
    assert float(np.abs(ref - exact).max()) > 0.1 * float(np.abs(exact).max())


def test_process_bc_and_plot_clis(hidim, tmp_path):
    """``process_bc`` (pca on the CPU) and ``plot`` write their outputs;
    the reduced directory opens in the loader and the GUI."""
    import shutil

    src = tmp_path / "run"
    shutil.copytree(hidim, src)
    out = tpbc.main(["1", "3", str(src), "8", "--method", "pca", "--device", "cpu"])
    assert out == f"{src}_pca" and tload.list_generations(out) == [1, 2, 3]
    cloud, orig = tload.load_offspring(out, 2, 2), tload.load_offspring(str(src), 2, 8)
    assert cloud.bc.shape == (24, 2)
    np.testing.assert_array_equal(cloud.noise_idx, orig.noise_idx)
    np.testing.assert_allclose(cloud.fitness, orig.fitness, rtol=1e-9)
    assert ti.Inspector([out], interactive=False).gens == [1, 2, 3]
    png = tmp_path / "clouds.png"
    tplot.main([out, "--out", str(png)])
    assert png.stat().st_size > 0
    png2 = tmp_path / "reduced.png"
    tplot.main([str(src), "--bc_dim", "8", "--reduce", "two_end", "--out", str(png2)])
    assert png2.stat().st_size > 0 and tload.list_generations(f"{src}_two_end") == [1, 2, 3]
    import matplotlib.pyplot as plt

    plt.close("all")


def test_pca_and_replay_need_a_card(hidim, snapdir, monkeypatch):
    """'pca' (the function, ``process`` and the CLI) and ``replay_point``
    run on cuda unless told otherwise: without a card, ``NoCudaDevice``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).randn(20, 4)
    with pytest.raises(NoCudaDevice):
        tred.reduce_dim(X, labels=np.zeros(20), method="pca")
    with pytest.raises(NoCudaDevice):
        tpbc.main(["1", "3", hidim, "8", "--method", "pca"])
    pt = ti.Point(gen=1, parent=False, x=0.0, y=0.0, fitness=1.0, row=np.array([0.0, 0.0, 1.0, 9.0, 30, 7, 1.0]))
    with pytest.raises(NoCudaDevice):
        treplay.replay_point(snapdir, pt)
    assert tred.reduce_dim(X, labels=np.zeros(20), method="pca", device="cpu").shape == (20, 2)


_BLOCKED = """
import sys
for name in ("matplotlib", "sklearn", "jax", "deep_neuroevolution_tpu"):
    sys.modules[name] = None
import numpy as np
import deep_neuroevolution_torch.inspector as insp
from deep_neuroevolution_torch.inspector import interactive, plot, process_bc, reduce, replay
X = np.random.RandomState(0).randn(30, 6)
print("two_end", reduce.reduce_dim(X, labels=np.zeros(30), method="two_end").shape)
print("pca", reduce.reduce_dim(X, labels=np.zeros(30), method="pca", device="cpu").shape)
for method in ("tsne", "lda"):
    try:
        reduce.reduce_dim(X, labels=np.zeros(30), method=method)
    except ImportError as e:
        print("refused:", e)
"""


def test_inspector_imports_without_matplotlib_and_sklearn():
    p = subprocess.run([sys.executable, "-c", _BLOCKED], capture_output=True, text=True, cwd=ROOT, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert "two_end (30, 2)" in p.stdout and "pca (30, 2)" in p.stdout
    for method in ("tsne", "lda"):
        assert f"refused: reduce_dim method '{method}' needs scikit-learn" in p.stdout


# ------------------------------------------------------------ the replays


def _capture(monkeypatch, viz_module, into: list):
    """Record the θ' that ``replay_point`` hands ``replay_snapshot``."""
    real = viz_module.replay_snapshot

    def recorded(*a, theta_override=None, **kw):
        into.append(theta_override)
        return real(*a, theta_override=theta_override, **kw)

    monkeypatch.setattr(viz_module, "replay_snapshot", recorded)


def _round_seeds(seed: int, rounds: int) -> list:
    """The host seeds of the JAX ``replay_policy``'s rounds."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(rounds):
        key, kround = jax.random.split(key)
        out.append(int(jax.random.randint(kround, (), 0, 2**31 - 1)))
    return out


def _offspring(sign: float, noise_idx: int, policy_seed: int):
    row = np.array([1.0, 2.0, 7.5, 30.0, noise_idx, policy_seed, sign])
    return ti.Point(gen=1, parent=False, x=1.0, y=2.0, fitness=7.5, row=row)


def test_replay_point_on_a_maze_snapshot(tmp_path, monkeypatch):
    """A ContinuousMLP maze parent (hidden 8) and two offspring rows (+1,
    −1): θ' bit for bit the JAX package's, 400-step episodes within rtol
    1e-5, trajectories ``[400, 1, 2]`` within 1e-2; the parent point
    replays the file's θ as it stands."""
    tm = tmodels.ContinuousMLP(obs_dim=11, ac_dim=2, hidden=8)
    theta = (0.3 * np.random.RandomState(4).randn(tm.num_params)).astype(np.float32)
    _make_snapshots(tmp_path, gens=[1], model=tm, theta=theta)
    jt, tt = JaxNoise.from_seed(count=10_000), TorchNoise.from_seed(count=10_000)
    jth, tth = [], []
    _capture(monkeypatch, jviz, jth)
    _capture(monkeypatch, tviz, tth)
    results = []
    for pt in (_offspring(1.0, 30, 77), _offspring(-1.0, 4321, 5),
               ti.Point(gen=1, parent=True, x=0.0, y=0.0, fitness=1.0, row=np.zeros(6))):
        j = jreplay.replay_point(str(tmp_path), pt, noise_table=jt)
        t = treplay.replay_point(str(tmp_path), pt, noise_table=tt, device="cpu")
        results.append(t)
        if pt.parent:
            assert jth[-1] is None and tth[-1] is None
        else:
            a, b = np.asarray(jth[-1]), tth[-1].numpy()
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
            assert t["seed"] == j["seed"] == int(pt.row[5])
            assert not np.array_equal(b, theta)
        assert t["lengths"] == j["lengths"] == [400]
        np.testing.assert_allclose(t["returns"], j["returns"], rtol=1e-5)
        assert t["bc_trajectory"].shape == np.asarray(j["bc_trajectory"]).shape == (400, 1, 2)
        np.testing.assert_allclose(t["bc_trajectory"], np.asarray(j["bc_trajectory"]), rtol=0, atol=1e-2)
    # a deterministic replay again: the same θ' and the same episode
    again = treplay.replay_point(str(tmp_path), _offspring(-1.0, 4321, 5), noise_table=tt, device="cpu")
    assert torch.equal(tth[-1], tth[1])
    assert again["returns"] == results[1]["returns"]
    np.testing.assert_array_equal(again["bc_trajectory"], results[1]["bc_trajectory"])


def test_toy_env_has_the_engines_own_slots():
    """``env_id='toy'`` (no ``env_kwargs``, as ``replay_point`` resolves
    it): the engine's own 64 slots in both packages."""
    from deep_neuroevolution_torch.utils import config as tconfig
    from deep_neuroevolution_tpu.utils import config as jconfig

    t, j = tconfig.resolve_env("toy"), jconfig.resolve_env("toy")
    try:
        assert t.batch_size == j.batch_size == 64
    finally:
        t.close()
        j.close()


def _few_slots(monkeypatch, slots: int = 4):
    """Both packages' replays resolve 'toy' to ``slots`` engine slots."""
    from deep_neuroevolution_tpu.utils import config as jconfig

    for module, real in ((jconfig, jconfig.resolve_env), (tviz, tviz.resolve_env)):
        monkeypatch.setattr(module, "resolve_env", lambda env_id, real=real, **kw: real(env_id, batch_size=slots, **kw))


def test_replay_point_on_a_vbn_dqn_snapshot(tmp_path, monkeypatch):
    """A VBN-DQN parent with its reference batch, replayed on ToyCatch
    (``env_id='toy'``, cut to 4 engine slots in both packages), one
    offspring row (−1), two episodes: θ' bit for bit, returns and lengths
    equal with the JAX round seeds fed in."""
    _few_slots(monkeypatch)
    jm, tm = jmodels.get_model("ModelVirtualBN")(num_actions=4), tmodels.VirtualBNDQN(num_actions=4)
    theta = np.asarray(jm.init_theta(jax.random.PRNGKey(1)))
    ref = np.random.RandomState(2).rand(16, 84, 84, 4).astype(np.float32)
    _make_snapshots(tmp_path, gens=[1], model=tm, theta=theta, ref_batch=ref)
    count = 2 * tm.num_params + 1000
    jt, tt = JaxNoise.from_seed(count=count), TorchNoise.from_seed(count=count)
    jth, tth = [], []
    _capture(monkeypatch, jviz, jth)
    _capture(monkeypatch, tviz, tth)
    pt = _offspring(-1.0, 123_456, 99)
    j = jreplay.replay_point(str(tmp_path), pt, noise_table=jt, env_id="toy", num_rollouts=2)
    monkeypatch.setattr(tviz, "_draw_seeds", lambda gen, n: _round_seeds(99, n))
    t = treplay.replay_point(str(tmp_path), pt, noise_table=tt, env_id="toy", num_rollouts=2, device="cpu")
    np.testing.assert_array_equal(np.asarray(jth[-1]).view(np.uint32), tth[-1].numpy().view(np.uint32))
    assert t["seed"] == j["seed"] == 99
    assert t["returns"] == j["returns"] and t["lengths"] == j["lengths"]
    assert np.asarray(t["bc_trajectory"]).shape == np.asarray(j["bc_trajectory"]).shape == (2, 128)
