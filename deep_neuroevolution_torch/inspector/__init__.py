"""VINE visual inspector: BC-cloud loading, dimensionality reduction,
static rendering, and the interactive linked-figure GUI over the
per-generation snapshot dumps (utils/vine.py).

The port's copy of the JAX package's inspector (after the reference's
visual_inspector/, ~1.5k LoC matplotlib GUI): the data layer (load_data),
the hi-dim reduction pipeline (process_bc + reduce; 'pca' in float64
torch on a device, 'tsne' and 'lda' on scikit-learn), static
multi-generation renderings (plot), and the interactive GUI (interactive:
linked cloud + fitness figures, fitness-binned color ramps, generation
navigation with visible-range caps, cloud modes, movie playback,
hover/pick annotations, and right-click rollout replay of any point via
the stored noise index + policy seed). Replays run through the port's
replay path (inspector/replay.py + utils/viz.py) on cuda unless told
otherwise. The package imports without matplotlib and scikit-learn.

GUI entry point: ``python -m deep_neuroevolution_torch.inspector.interactive
START END SNAPSHOTS_PATH... [--device cpu]``.
"""

from .load_data import list_generations, load_offspring, load_parent  # noqa: F401
from .reduce import assemble, disassemble, reduce_dim  # noqa: F401
from .plot import plot_cloud_series  # noqa: F401
from .interactive import Inspector  # noqa: F401
