"""Interactive VINE GUI: linked pseudo-offspring-cloud and fitness figures.

The port's copy of the JAX package's inspector/interactive.py, after the
reference's visual_inspector/figure_base/figure_control.py (central
visibility control), cloud_figures.py (CloudPlot: per-generation clouds
binned by fitness into color ramps, parent trail, annotations, colorbar,
movie playback), fitness_figures.py (FitnessPlot: parent-fitness curve +
discrete slider + click-to-jump), buttons.py (Home/Reset/Movie/Prev/Next,
visible-range and cloud-mode radios, Random-Seed/Fast-Pace/Save-Movie
checks), mouse_event.py (pick + hover events), and
figure_custom/cloud_figures_custom.py (hi-dim-BC trajectory plot).

One ``Inspector`` instance owns all state; the binning and ramp math is
numpy; right-click replay is an injectable callback, by default
inspector.replay.replay_point, which rebuilds the clicked offspring's θ
from the stored noise index and rolls it out through the port's replay
path on ``device`` (default cuda; ``NoCudaDevice`` without a card, and
``--device cpu`` on the command line runs it on the CPU). Loading and
drawing use no device. Arrow keys page generations.

Works headless (Agg): every state transition is a plain method, so tests
drive them without a display; ``show()`` blocks only when a GUI backend is
active. matplotlib is imported when a figure is built, never at import.

    python -m deep_neuroevolution_torch.inspector.interactive START END SNAPSHOTS_PATH... \
        [--visible_range N] [--hi_dim_bc PATH DIM] [--device cuda|cpu]
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .load_data import list_generations, load_offspring, load_parent

NUM_BINS = 5  # fitness color bins per generation (settings.py numBins)
TOP_SIZE = 10  # size of the split-off "Top" bucket (load_data.py:92-99)

# (light, dark) ramp endpoints per generation, cycled — settings.py COLORS
_RAMPS = [
    ("#f9d9d9", "#d61515"),  # red
    ("#d9ddfb", "#0b1667"),  # blue
    ("#9aecb8", "#045c24"),  # green
    ("#ffbef9", "#ce00bb"),  # pink
    ("#d0d0d0", "#000000"),  # black
    ("#f2d6b9", "#996633"),  # brown
    ("#d5b2ec", "#9900ff"),  # purple
    ("#baffff", "#009999"),  # teal
    ("#ffb27e", "#fb6500"),  # orange
    ("#beffcf", "#33ff66"),  # lime
]
MARKERS = ["D", "o", "v", "s", "^", "<", ">", "*", "h", "H", "d", "X"]


def _ramp(light: str, dark: str, n: int = NUM_BINS) -> List[str]:
    a = np.array([int(light[i : i + 2], 16) for i in (1, 3, 5)], float)
    b = np.array([int(dark[i : i + 2], 16) for i in (1, 3, 5)], float)
    out = []
    for t in np.linspace(0.0, 1.0, n):
        rgb = np.round(a + (b - a) * t).astype(int)
        out.append("#%02x%02x%02x" % tuple(rgb))
    return out


COLOR_RAMPS = [_ramp(lo, hi) for lo, hi in _RAMPS]


def gen_colors(gen: int) -> List[str]:
    return COLOR_RAMPS[gen % len(COLOR_RAMPS)]


def gen_marker(gen: int) -> str:
    return MARKERS[gen % len(MARKERS)]


def color_index(fitness: float, minfit: float, maxfit: float) -> int:
    """Bin index of a fitness value in [minfit, maxfit] (load_data.py:7-18)."""
    if maxfit == minfit:
        return 0
    return int(np.clip((fitness - minfit) / (maxfit - minfit) * NUM_BINS, 0, NUM_BINS - 1))


def bin_offspring(fitness_sorted: np.ndarray, parent_fitness: float):
    """Split sorted fitness values into NUM_BINS equal-width bins over
    [min(parent, pop), max(parent, pop)], plus a separate top-TOP_SIZE
    bucket when the last bin holds more than TOP_SIZE points
    (load_data.py:68-99 semantics)."""
    n = len(fitness_sorted)
    maxfit = max(parent_fitness, float(fitness_sorted[-1]))
    minfit = min(parent_fitness, float(fitness_sorted[0]))
    edges = np.linspace(minfit, maxfit, NUM_BINS + 1)[1:NUM_BINS]
    cuts = np.searchsorted(fitness_sorted, edges, side="right")
    bounds = [0, *cuts.tolist()]
    bins = [range(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    left, right = bounds[-1], n
    if right - left <= TOP_SIZE:
        bins.append(range(left, right))
    else:
        bins.append(range(left, right - TOP_SIZE))
        bins.append(range(right - TOP_SIZE, right))
    return bins, minfit, maxfit


@dataclass
class Point:
    """A selected cloud point (load_data.py DataPoint analog).

    `row` is the raw .dat row; for offspring the trailing columns are
    [noise_idx, policy_seed, sign] (utils/vine.py layout)."""

    gen: int
    parent: bool
    x: float
    y: float
    fitness: float
    row: np.ndarray
    xs: np.ndarray = None  # full trajectory halves for hi-dim BCs
    ys: np.ndarray = None

    @property
    def message(self) -> str:
        kind = "Parent" if self.parent else "Offspring"
        return (
            f"Gen {self.gen} {kind} x = {self.x:.6f}  y = {self.y:.6f} "
            f"fitness (on record) = {self.fitness:.8f}"
        )


@dataclass
class _GenArtists:
    parent_artist: object
    parent_xy: Tuple[float, float]
    parent_fitness: float
    table: np.ndarray  # offspring rows sorted by fitness
    bins: List[range] = field(default_factory=list)
    bin_artists: List[object] = field(default_factory=list)
    annotation: object = None
    minfit: float = 0.0
    maxfit: float = 0.0


class CloudPlot:
    """One figure with per-generation offspring clouds + the parent trail."""

    def __init__(self, inspector: "Inspector", title: str, path: str, bc_dim: int = 2):
        import matplotlib.pyplot as plt

        self.insp = inspector
        self.path = path
        self.bc_dim = bc_dim
        self.title = title
        self.fig = plt.figure(title, figsize=(9, 7))
        self.ax = self.fig.add_subplot(111)
        self.ax.grid(True)
        self.gens: Dict[int, _GenArtists] = {}
        self._artist2gen: Dict[object, int] = {}
        self._artist2bin: Dict[object, range] = {}
        self._load_and_plot()

        self.hover_annot = self.ax.annotate(
            "", xy=(0, 0), xytext=(0, -40), textcoords="offset points",
            arrowprops=dict(arrowstyle="->"), fontsize=18, color="b",
        )
        self.hover_annot.set_visible(False)
        self.select_annot = self.ax.annotate(
            "", xy=(0, 0), xytext=(20, 20), textcoords="offset points",
            arrowprops=dict(facecolor="blue", shrink=0.05, alpha=0.5),
        )
        self.select_annot.set_visible(False)
        self.cbar_ax = self.fig.add_axes([0.91, 0.1, 0.03, 0.8])
        self.cbar_ax.set_visible(False)
        self.home_xlim = self.ax.get_xlim()
        self.home_ylim = self.ax.get_ylim()

        self.panel = ControlPanel(self)
        self.fig.canvas.mpl_connect("pick_event", self._on_pick)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_move)
        self.fig.canvas.mpl_connect("key_press_event", self.insp.on_key)
        self.fig.canvas.mpl_connect("close_event", self.insp.on_close)

    # ------------------------------------------------------------- loading

    def _split_xy(self, row: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Trajectory-BC convention: first half = xs, second half = ys; the
        plotted point is the final (x, y) (load_data.py:56-58)."""
        d = self.bc_dim
        return row[: d // 2], row[d // 2 : d]

    def _load_and_plot(self) -> None:
        trail_x, trail_y = [], []
        for gen in self.insp.gens:
            parent = load_parent(self.path, gen, self.bc_dim)
            pxs, pys = self._split_xy(np.asarray(parent.bc, float))
            px, py = float(pxs[-1]), float(pys[-1])
            trail_x.append(px)
            trail_y.append(py)

            cloud = load_offspring(self.path, gen, self.bc_dim)
            rows = np.column_stack(
                [cloud.bc, cloud.fitness, cloud.length, cloud.noise_idx, cloud.policy_seed, cloud.sign]
            )
            order = np.argsort(rows[:, self.bc_dim], kind="stable")
            table = rows[order]
            bins, minfit, maxfit = bin_offspring(table[:, self.bc_dim], parent.fitness)
            colors = gen_colors(gen)
            marker = gen_marker(gen)

            (pa,) = self.ax.plot(
                px, py, marker=marker, picker=3,
                color=colors[color_index(parent.fitness, minfit, maxfit)],
            )
            ga = _GenArtists(pa, (px, py), parent.fitness, table, bins,
                             minfit=minfit, maxfit=maxfit)
            self._artist2gen[pa] = gen

            top_i = len(bins) - 1
            for i, b in enumerate(bins):
                if len(b) == 0:
                    continue
                xs = [self._split_xy(table[j])[0][-1] for j in b]
                ys = [self._split_xy(table[j])[1][-1] for j in b]
                cidx = min(i, NUM_BINS - 1)
                (oa,) = self.ax.plot(
                    xs, ys, marker, color=colors[cidx],
                    markersize=10 if i == top_i else 6, linestyle="",
                )
                oa.set_visible(False)
                ga.bin_artists.append(oa)
                self._artist2gen[oa] = gen
                self._artist2bin[oa] = b
            self.gens[gen] = ga

        (self.trail,) = self.ax.plot(trail_x, trail_y, "grey", linestyle="--")

    # ---------------------------------------------------------- visibility

    def show_gen(self, gen: int) -> None:
        ga = self.gens[gen]
        ga.parent_artist.set_markersize(15)
        if ga.annotation is None:
            ga.annotation = self.ax.annotate(
                str(gen), xy=ga.parent_xy, xytext=(-6 * len(str(gen)), 40),
                textcoords="offset points", arrowprops=dict(arrowstyle="->"), fontsize=18,
            )
        ga.annotation.set_visible(True)
        mode = self.insp.cloud_mode
        shown = []
        if mode == "all":
            shown = ga.bin_artists
        elif mode == "top":
            shown = ga.bin_artists[-1:]
        for a in shown:
            a.set_visible(True)
            a.set_picker(2 if mode == "all" else 5)

    def hide_gen(self, gen: int) -> None:
        ga = self.gens[gen]
        ga.parent_artist.set_markersize(6)
        if ga.annotation is not None:
            ga.annotation.set_visible(False)
        for a in ga.bin_artists:
            a.set_visible(False)
            a.set_picker(False)

    # ------------------------------------------------------------- points

    def point_from_row(self, gen: int, row: np.ndarray) -> Point:
        xs, ys = self._split_xy(row)
        return Point(gen, False, float(xs[-1]), float(ys[-1]),
                     float(row[self.bc_dim]), row, xs=xs, ys=ys)

    def parent_point(self, gen: int) -> Point:
        ga = self.gens[gen]
        parent = load_parent(self.path, gen, self.bc_dim)
        row = np.concatenate([np.asarray(parent.bc, float),
                              [parent.fitness, parent.length], parent.extras])
        xs, ys = self._split_xy(np.asarray(parent.bc, float))
        return Point(gen, True, *ga.parent_xy, ga.parent_fitness, row, xs=xs, ys=ys)

    def show_labels(self, point: Point) -> None:
        self.show_colorbar(point.gen)
        self.fig.suptitle(point.message)
        if not point.parent:
            self.select_annot.xy = (point.x, point.y)
            self.select_annot.set_visible(True)
        else:
            self.select_annot.set_visible(False)

    def clear_labels(self) -> None:
        self.cbar_ax.set_visible(False)
        self.fig.suptitle("")
        self.select_annot.set_visible(False)

    def show_colorbar(self, gen: int) -> None:
        import matplotlib as mpl

        ga = self.gens[gen]
        self.cbar_ax.clear()
        self.cbar_ax.set_visible(True)
        cmap = mpl.colors.ListedColormap(gen_colors(gen))
        lo, hi = ga.minfit, ga.maxfit
        if hi - lo < 1e-12:  # degenerate range (all rollouts scored alike)
            lo, hi = lo - 0.5, hi + 0.5
        bounds = np.around(np.linspace(lo, hi, NUM_BINS + 1))
        if not np.all(np.diff(bounds) > 0):  # rounding collapsed tight ranges
            bounds = np.linspace(lo, hi, NUM_BINS + 1)
        norm = mpl.colors.BoundaryNorm(bounds, cmap.N)
        mpl.colorbar.ColorbarBase(self.cbar_ax, cmap=cmap, norm=norm, orientation="vertical")

    def set_hover(self, gen: Optional[int]) -> None:
        if gen is None:
            self.hover_annot.set_visible(False)
        else:
            ga = self.gens[gen]
            self.hover_annot.xy = ga.parent_xy
            self.hover_annot.set_text(str(gen))
            self.hover_annot.set_visible(True)

    def reset_view(self) -> None:
        self.ax.set_xlim(*self.home_xlim)
        self.ax.set_ylim(*self.home_ylim)

    # -------------------------------------------------------------- events

    def _on_pick(self, event) -> None:
        if not len(event.ind):
            return
        artist, idx = event.artist, event.ind[-1]
        gen = self._artist2gen.get(artist)
        if gen is None:
            return
        button = getattr(event.mouseevent, "button", 1)
        if artist is self.gens[gen].parent_artist:
            if button == 3:
                self.insp.select_point(self.parent_point(gen))
            else:
                self.insp.toggle_gen(gen)
        else:
            b = self._artist2bin[artist]
            row = self.gens[gen].table[b[idx]]
            point = self.point_from_row(gen, row)
            self.insp.select_point(point)
            if button == 3:
                self.insp.replay(self, point)

    def _on_move(self, event) -> None:
        if event.inaxes is not self.ax:
            return
        cont, ind = self.trail.contains(event)
        if cont:
            self.insp.hover(self.insp.gens[ind["ind"][0]])
        else:
            self.insp.hover(None)

    # --------------------------------------------------------------- movie

    def play_movie(self, start: int, stop: int) -> "object":
        """Accumulating-cloud animation over [start, stop] at the current
        pace (cloud_figures.py:219-263); returns the animation object."""
        import matplotlib.animation as animation
        import matplotlib.pyplot as plt

        t0 = time.time()
        fig = plt.figure(self.title + " Movie")
        ax = fig.add_subplot(111)
        ax.grid(True)
        frames, trail_x, trail_y = [], [], []
        span = [g for g in self.insp.gens if start <= g <= stop]
        for k, gen in enumerate(span):
            ga = self.gens[gen]
            ax.plot(*ga.parent_xy, marker=gen_marker(gen),
                    color=ga.parent_artist.get_color())
            trail_x.append(ga.parent_xy[0])
            trail_y.append(ga.parent_xy[1])
            if k in (0, len(span) - 1) or k % self.insp.step == 0:
                label = ax.annotate(f"Gen {gen}", (0, 0), xycoords="axes points",
                                    fontsize=32, color=ga.parent_artist.get_color())
                frame = [label]
                for a in ga.bin_artists:
                    x, y = a.get_data()
                    (pt,) = ax.plot(x, y, a.get_marker(), color=a.get_color(),
                                    markersize=a.get_markersize())
                    frame.append(pt)
                frames.append(frame)
        ax.plot(trail_x, trail_y, "grey", linestyle="--")
        interval = min(1000, 30000 / max(len(frames), 1))
        ani = animation.ArtistAnimation(fig, frames, interval=interval, blit=True,
                                        repeat_delay=1000, repeat=True)
        if self.insp.save_movie:
            try:
                ani.save(f"vine_movie_{int(time.time())}.mp4")
            except Exception as e:  # no ffmpeg — keep the GUI alive
                print(f"could not save movie: {e}")
        print(f"movie built in {time.time() - t0:.1f}s ({len(frames)} frames)")
        if self.insp.interactive:
            fig.show()
        return ani


class HiDimCloudPlot(CloudPlot):
    """Cloud plot over dimensionality-reduced points whose rows carry the
    full high-dim BC; selecting a point draws its trajectory
    (figure_custom/cloud_figures_custom.py CloudPlotHDBC)."""

    def __init__(self, inspector, title, path, bc_dim):
        super().__init__(inspector, title, path, bc_dim=bc_dim)
        (self.traj_line,) = self.ax.plot([], [], color="k", linewidth=3)

    def show_labels(self, point: Point) -> None:
        super().show_labels(point)
        if point.xs is not None and len(point.xs) > 1:
            self.traj_line.set_data(point.xs, point.ys)


class FitnessPlot:
    """Parent fitness vs generation with a discrete slider and pick-to-jump
    (fitness_figures.py)."""

    def __init__(self, inspector: "Inspector", path: str, bc_dim: int = 2):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Slider

        self.insp = inspector
        self.x = list(inspector.gens)
        self.y = [load_parent(path, g, bc_dim).fitness for g in self.x]
        self.fig = plt.figure("Fitness Plot")
        self.ax = self.fig.add_subplot(111)
        (self.curve,) = self.ax.plot(self.x, self.y, "--", picker=3)
        self.ax.set_ylabel("Fitness")
        self.ax.grid(True)
        lo, hi = min(self.y), max(self.y)
        pad = 0.05 * max(abs(lo), abs(hi), 1e-9)
        self.ax.set_ylim(lo - pad, hi + pad)

        self.hover_annot = self.ax.annotate(
            "", xy=(0, 0), xytext=(0, -40), textcoords="offset points",
            arrowprops=dict(arrowstyle="->"), fontsize=18, color="b",
        )
        self.hover_annot.set_visible(False)
        (self.dot,) = self.ax.plot(self.x[0], self.y[0], "o", markersize=15,
                                   markerfacecolor="None", markeredgecolor="red",
                                   markeredgewidth=3)
        self.dot.set_visible(False)
        self._markers: Dict[int, Tuple[object, object]] = {}

        self.slider_ax = self.fig.add_axes([0.125, 0.02, 0.775, 0.03], facecolor="yellow")
        self.slider = Slider(self.slider_ax, "Gen", self.x[0], self.x[-1],
                             valinit=self.x[0], valstep=1, valfmt="%0.0f")
        self._slider_quiet = False
        self.slider.on_changed(self._on_slider)
        self.fig.canvas.mpl_connect("pick_event", self._on_pick)
        self.fig.canvas.mpl_connect("motion_notify_event", self._on_move)
        self.fig.canvas.mpl_connect("key_press_event", self.insp.on_key)
        self.fig.canvas.mpl_connect("close_event", self.insp.on_close)

    def _on_slider(self, value) -> None:
        if self._slider_quiet:
            return
        gen = int(value)
        if gen in self.insp.gens and not self.insp.is_visible(gen):
            self.insp.show(gen, mode="dist")

    def set_val(self, gen: int) -> None:
        self._slider_quiet = True
        try:
            self.slider.set_val(gen)
        finally:
            self._slider_quiet = False
        i = self.x.index(gen)
        self.dot.set_data([gen], [self.y[i]])
        self.dot.set_visible(True)
        self.ax.set_title(f"Gen {gen}  Fitness {self.y[i]:.8f}")

    def mark_visible(self, gen: int, visible: bool) -> None:
        if gen not in self._markers:
            i = self.x.index(gen)
            (pt,) = self.ax.plot(gen, self.y[i], gen_marker(gen),
                                 color=gen_colors(gen)[-1], markersize=10)
            annot = self.ax.annotate(str(gen), xy=(gen, self.y[i]),
                                     xytext=(-6 * len(str(gen)), 40),
                                     textcoords="offset points",
                                     arrowprops=dict(arrowstyle="->"), fontsize=18)
            self._markers[gen] = (pt, annot)
        for a in self._markers[gen]:
            a.set_visible(visible)

    def reset(self) -> None:
        self.dot.set_visible(False)
        self.ax.set_title("")
        for pt, annot in self._markers.values():
            pt.set_visible(False)
            annot.set_visible(False)

    def set_hover(self, gen: Optional[int]) -> None:
        if gen is None:
            self.hover_annot.set_visible(False)
        else:
            i = self.x.index(gen)
            self.hover_annot.xy = (gen, self.y[i])
            self.hover_annot.set_text(str(gen))
            self.hover_annot.set_visible(True)

    def _on_pick(self, event) -> None:
        if event.artist is self.curve and len(event.ind):
            gen = self.x[event.ind[-1]]
            self.insp.toggle_gen(gen)

    def _on_move(self, event) -> None:
        if event.inaxes is not self.ax:
            return
        cont, ind = self.curve.contains(event)
        self.insp.hover(self.x[ind["ind"][-1]] if cont else None)


class ControlPanel:
    """Buttons/radios/checks attached to a cloud figure (buttons.py)."""

    def __init__(self, cplot: CloudPlot):
        from matplotlib.widgets import Button, CheckButtons, RadioButtons

        insp, fig = cplot.insp, cplot.fig
        self.cplot = cplot
        names = ["Home", "Reset", "Movie", "Prev", "Next"]
        calls = [lambda e: insp.home(), lambda e: insp.reset(),
                 lambda e: insp.movie(self.cplot), lambda e: insp.prev(),
                 lambda e: insp.next()]
        self.buttons = []
        for i, (name, cb) in enumerate(zip(names, calls)):
            ax = fig.add_axes([0.46 + 0.09 * i, 0.01, 0.08, 0.05])
            b = Button(ax, name)
            b.on_clicked(cb)
            self.buttons.append(b)

        ax = fig.add_axes([0.0, 0.0, 0.28, 0.09])
        ax.axis("off")
        self.checks = CheckButtons(
            ax, ["Random\nSeed", "Fast\nPace", "Save\nMovie"],
            [insp.stochastic, insp.step > 1, insp.save_movie],
        )
        self.checks.on_clicked(self._on_check)

        ax = fig.add_axes([0.0, 0.78, 0.12, 0.14])
        ax.axis("off")
        self.radio_range = RadioButtons(ax, ("1", "2", "3"),
                                        active=min(insp.max_visible, 3) - 1)
        self.radio_range.on_clicked(lambda label: insp.set_visible_range(int(label)))

        ax = fig.add_axes([0.0, 0.58, 0.12, 0.14])
        ax.axis("off")
        modes = {"All": "all", "Top": "top", "None": "none"}
        active = list(modes.values()).index(insp.cloud_mode)
        self.radio_cloud = RadioButtons(ax, tuple(modes), active=active)
        self.radio_cloud.on_clicked(lambda label: insp.set_cloud_mode(modes[label]))

    def _on_check(self, label: str) -> None:
        insp = self.cplot.insp
        if label.startswith("Random"):
            insp.stochastic = not insp.stochastic
        elif label.startswith("Fast"):
            insp.toggle_fast_pace()
        elif label.startswith("Save"):
            insp.save_movie = not insp.save_movie


class Inspector:
    """Coordinates all linked figures (figure_control.py FigureControl)."""

    def __init__(
        self,
        paths: Sequence[str],
        start: Optional[int] = None,
        end: Optional[int] = None,
        bc_dim: int = 2,
        visible_range: Optional[int] = None,
        hi_dim_bc: Optional[Tuple[str, int]] = None,
        replay_fn: Optional[Callable] = None,
        interactive: bool = True,
        device=None,
    ):
        all_gens = list_generations(paths[0])
        assert all_gens, f"no snapshot generations under {paths[0]}"
        start = all_gens[0] if start is None else int(start)
        end = all_gens[-1] if end is None else int(end)
        self.gens = [g for g in all_gens if start <= g <= end]
        assert self.gens, f"no generations in [{start}, {end}]"

        self.visible: set = set()
        self.cloud_mode = "all"
        self.stochastic = False
        self.save_movie = False
        self.max_visible = max(1, int(visible_range)) if visible_range else 1
        self.step = 1
        if len(self.gens) >= 100:
            self.step = max(1, len(self.gens) // 10)
        self.interactive = interactive
        self.replay_fn = replay_fn
        self.device = device  # the replays' (None: cuda)
        self._animations = []  # keep references alive

        self.cloud_plots: List[CloudPlot] = []
        for i, path in enumerate(paths):
            self.cloud_plots.append(
                CloudPlot(self, f"Cloud Plot {i} ({path})", path, bc_dim)
            )
        if hi_dim_bc is not None:
            hd_path, hd_dim = hi_dim_bc
            self.cloud_plots.append(
                HiDimCloudPlot(self, f"Cloud Plot {hd_dim}-D BC ({hd_path})", hd_path, int(hd_dim))
            )
        self.fitness_plot = FitnessPlot(self, paths[0], bc_dim)

    # --------------------------------------------------------- visibility

    def is_visible(self, gen: int) -> bool:
        return gen in self.visible

    def show(self, gen: int, mode: str = "dist") -> None:
        for cp in self.cloud_plots:
            cp.show_labels(cp.parent_point(gen))
        if self.visible:
            self._enforce_range(mode, gen)
        self.visible.add(gen)
        for cp in self.cloud_plots:
            cp.show_gen(gen)
        self.fitness_plot.mark_visible(gen, True)
        self.fitness_plot.set_val(gen)
        self._draw()

    def hide(self, gen: int) -> None:
        self.visible.discard(gen)
        for cp in self.cloud_plots:
            cp.hide_gen(gen)
        self.fitness_plot.mark_visible(gen, False)
        self._draw()

    def toggle_gen(self, gen: int) -> None:
        if self.is_visible(gen):
            self.hide(gen)
        else:
            self.show(gen, mode="dist")

    def _enforce_range(self, mode: str, new_gen: int) -> None:
        """Drop generations until the visible set fits the range cap
        (figure_control.py applyVisibleRange)."""
        while self.visible and len(self.visible) >= self.max_visible:
            lo, hi = min(self.visible), max(self.visible)
            if mode == "next":
                drop = lo
            elif mode == "prev":
                drop = hi
            else:
                drop = lo if abs(new_gen - lo) >= abs(new_gen - hi) else hi
            self.hide(drop)

    # --------------------------------------------------------- navigation

    def next(self) -> None:
        if self.is_visible(self.gens[-1]):
            self._error("max gen already displayed")
            return
        gen = self.gens[0]
        if self.visible:
            i = self.gens.index(max(self.visible))
            gen = self.gens[min(i + self.step, len(self.gens) - 1)]
        self.show(gen, mode="next")

    def prev(self) -> None:
        if self.is_visible(self.gens[0]):
            self._error("min gen already displayed")
            return
        gen = self.gens[-1]
        if self.visible:
            i = self.gens.index(min(self.visible))
            gen = self.gens[max(i - self.step, 0)]
        self.show(gen, mode="prev")

    def reset(self) -> None:
        while self.visible:
            self.hide(max(self.visible))
        for cp in self.cloud_plots:
            cp.clear_labels()
        self.fitness_plot.reset()
        self.home()

    def home(self) -> None:
        for cp in self.cloud_plots:
            cp.reset_view()
        self._draw()

    # ------------------------------------------------------------ options

    def set_visible_range(self, n: int) -> None:
        self.max_visible = max(1, int(n))

    def set_cloud_mode(self, mode: str) -> None:
        assert mode in ("all", "top", "none")
        if mode == self.cloud_mode:
            return
        self.cloud_mode = mode
        for gen in list(self.visible):
            for cp in self.cloud_plots:
                cp.hide_gen(gen)
                cp.show_gen(gen)
        self._draw()

    def toggle_fast_pace(self) -> None:
        if self.step > 1:
            self.step = 1
        else:
            self.step = max(1, len(self.gens) // 10)

    # ------------------------------------------------------------ actions

    def select_point(self, point: Point) -> None:
        for cp in self.cloud_plots:
            if point.parent:
                cp.show_labels(cp.parent_point(point.gen))
            else:
                cp.show_labels(point)
        self._draw()

    def replay(self, cplot: CloudPlot, point: Point) -> Optional[dict]:
        """Right-click replay: deterministic via the stored policy seed, or
        stochastic when the Random Seed box is checked."""
        fn = self.replay_fn
        if fn is None:
            from .replay import plot_replay_trajectory, replay_point

            def fn(path, pt, stochastic):
                res = replay_point(path, pt, stochastic=stochastic, bc_dim=cplot.bc_dim, device=self.device)
                print(f"replay gen {pt.gen}: return={res['return_mean']:.4f} "
                      f"len={res['length_mean']:.0f} seed={res['seed']}")
                plot_replay_trajectory(cplot.ax, res)
                self._draw()
                return res

        return fn(cplot.path, point, self.stochastic)

    def hover(self, gen: Optional[int]) -> None:
        for cp in self.cloud_plots:
            cp.set_hover(gen)
        self.fitness_plot.set_hover(gen)
        self._draw()

    def movie(self, cplot: CloudPlot) -> object:
        start = min(self.visible) if self.visible else self.gens[0]
        ani = cplot.play_movie(start, self.gens[-1])
        self._animations.append(ani)
        return ani

    # ------------------------------------------------------------- events

    def on_key(self, event) -> None:
        if event.key == "right":
            self.next()
        elif event.key == "left":
            self.prev()

    def on_close(self, event) -> None:
        import matplotlib.pyplot as plt

        canvases = [cp.fig.canvas for cp in self.cloud_plots]
        if event.canvas is self.fitness_plot.fig.canvas:
            plt.close("all")
        elif event.canvas in canvases:
            cp = self.cloud_plots[canvases.index(event.canvas)]
            self.cloud_plots.remove(cp)
            if not self.cloud_plots:
                plt.close("all")

    # ------------------------------------------------------------ helpers

    def _error(self, msg: str) -> None:
        for cp in self.cloud_plots:
            cp.fig.suptitle(msg)
        self._draw()

    def _draw(self) -> None:
        if not self.interactive:
            return
        for cp in self.cloud_plots:
            cp.fig.canvas.draw_idle()
        self.fitness_plot.fig.canvas.draw_idle()


def main(argv=None):
    import argparse

    import matplotlib

    p = argparse.ArgumentParser(
        prog="deep_neuroevolution_torch.inspector.interactive",
        description="Interactive VINE GUI (main_mujoco.py/main_atari.py analog)",
    )
    p.add_argument("start_iter", type=int)
    p.add_argument("end_iter", type=int)
    p.add_argument("snapshots_path", nargs="+")
    p.add_argument("--visible_range", type=int, default=None,
                   help="up to how many generations visible at once")
    p.add_argument("--hi_dim_bc", nargs=2, metavar=("PATH", "DIM"), default=None,
                   help="path to a high-dimensional BC dump and its dimension")
    p.add_argument("--device", default="cuda", help="where right-click replays run (cuda or cpu)")
    args = p.parse_args(argv)

    interactive = matplotlib.get_backend().lower() != "agg"
    insp = Inspector(
        args.snapshots_path, args.start_iter, args.end_iter,
        visible_range=args.visible_range,
        hi_dim_bc=(args.hi_dim_bc[0], int(args.hi_dim_bc[1])) if args.hi_dim_bc else None,
        interactive=interactive,
        device=args.device,
    )
    if interactive:
        import matplotlib.pyplot as plt

        plt.show()
    return insp


if __name__ == "__main__":
    main()
