"""Cloud + fitness plotting: the static rendering of VINE's linked figures
(visual_inspector/figure_base/cloud_figures.py CloudPlot + fitness plot).

The port's copy of the JAX package's inspector/plot.py. Per generation:
the offspring BC cloud scattered and colored by fitness, the parent BC
marked, and a fitness-over-generations curve alongside, written to PNG
(headless) or shown where a display exists. matplotlib is imported when a
plot is drawn, never at import. The Hard Maze's walls come from the port's
envs/maze.py; a fault there fails the plot.

    python -m deep_neuroevolution_torch.inspector.plot PATH [--gens ...] [--bc_dim 2] \
        [--out vine_clouds.png] [--reduce pca|tsne|lda|two_end|downsampling] [--device cuda|cpu]
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .load_data import list_generations, load_offspring, load_parent


def plot_cloud_series(
    path: str,
    gens: Optional[Sequence[int]] = None,
    bc_dim: int = 2,
    out_png: Optional[str] = None,
    show: bool = False,
    maze_walls: bool = True,
):
    """Render offspring clouds for `gens` (default: all found) + parent path
    + per-generation fitness curve."""
    import matplotlib

    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gens = list(gens) if gens is not None else list_generations(path)
    assert gens, f"no snapshot generations under {path}"

    fig, (ax_cloud, ax_fit) = plt.subplots(
        1, 2, figsize=(13, 6), gridspec_kw={"width_ratios": [7, 5]}
    )

    cmap = plt.get_cmap("viridis")
    all_f = []
    parents = []
    for i, gen in enumerate(gens):
        cloud = load_offspring(path, gen, bc_dim)
        frac = i / max(len(gens) - 1, 1)
        ax_cloud.scatter(
            cloud.bc[:, 0],
            cloud.bc[:, 1],
            s=8,
            alpha=0.35,
            color=cmap(frac),
            label=f"gen {gen}" if len(gens) <= 8 else None,
        )
        all_f.append((gen, cloud.fitness))
        try:
            parents.append((gen, load_parent(path, gen, bc_dim)))
        except OSError:
            pass

    if parents:
        px = [p.bc[0] for _, p in parents]
        py = [p.bc[1] for _, p in parents]
        ax_cloud.plot(px, py, "r.-", lw=1.5, ms=10, label="parent")

    if maze_walls and bc_dim == 2:
        # overlay the hard-maze geometry when the BC is maze (x, y)
        from ..envs.maze import HARD_MAZE_TXT, parse_maze

        cfg = parse_maze(HARD_MAZE_TXT)
        xs = np.concatenate([cfg["segs"][:, [0, 2]], np.full((len(cfg["segs"]), 1), np.nan)], 1).ravel()
        ys = np.concatenate([cfg["segs"][:, [1, 3]], np.full((len(cfg["segs"]), 1), np.nan)], 1).ravel()
        ax_cloud.plot(xs, ys, "k-", lw=0.8, alpha=0.5)
        ax_cloud.plot(*cfg["end"], "g*", ms=14, label="goal")

    ax_cloud.set_title("Offspring BC clouds")
    ax_cloud.set_xlabel("BC[0]")
    ax_cloud.set_ylabel("BC[1]")
    if len(gens) <= 8 or parents:
        ax_cloud.legend(loc="best", fontsize=8)

    gen_ids = [g for g, _ in all_f]
    means = [f.mean() for _, f in all_f]
    maxs = [f.max() for _, f in all_f]
    ax_fit.plot(gen_ids, means, "o-", label="pop mean")
    ax_fit.plot(gen_ids, maxs, "s--", label="pop max")
    if parents:
        ax_fit.plot([g for g, _ in parents], [p.fitness for _, p in parents], "r.-", label="parent")
    ax_fit.set_title("Fitness")
    ax_fit.set_xlabel("generation")
    ax_fit.legend()
    fig.tight_layout()

    if out_png:
        fig.savefig(out_png, dpi=120)
    if show:
        plt.show()
    plt.close(fig)
    return out_png


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="deep_neuroevolution_torch.inspector.plot")
    p.add_argument("path", help="log dir containing snapshots/")
    p.add_argument("--gens", type=int, nargs="*", default=None)
    p.add_argument("--bc_dim", type=int, default=2)
    p.add_argument("--out", default="vine_clouds.png")
    p.add_argument("--reduce", default=None, choices=["pca", "tsne", "lda", "two_end", "downsampling"],
                   help="reduce hi-dim BCs first (process_bc.py pipeline)")
    p.add_argument("--device", default="cuda", help="where --reduce pca runs (cuda or cpu)")
    args = p.parse_args(argv)

    path = args.path
    if args.reduce:
        from .process_bc import reduced
        from .reduce import assemble, disassemble

        gens = args.gens or list_generations(path)
        X, p_opt, ch_opt, num_os, labels = assemble(min(gens), max(gens), path, bc_dim=args.bc_dim)
        X_r = reduced(X, labels, args.reduce, args.device)
        path = disassemble(
            X_r, p_opt, ch_opt, args.reduce,
            start_iter=min(gens), end_iter=max(gens), path=path, chunk=1 + num_os,
        )
        args.bc_dim = 2
    out = plot_cloud_series(path, args.gens, args.bc_dim, out_png=args.out)
    print(out)


if __name__ == "__main__":
    main()
