"""Standalone hi-dim BC reduction CLI (visual_inspector/process_bc.py:19-53).

    python -m deep_neuroevolution_torch.inspector.process_bc START END PATH DIM \
        [--method pca|tsne|lda|downsampling|two_end] [--ds_ratio 1.0] [--device cuda|cpu]

The port's copy of the JAX package's inspector/process_bc.py. Writes
reduced 2-D .dat snapshots under ``<PATH>_<method>/``, which the
interactive GUI opens directly. 'pca' runs in float64 on ``--device``
(default cuda; ``NoCudaDevice`` without a card); 'tsne' and 'lda' need
scikit-learn.
"""

from __future__ import annotations

import numpy as np

from .reduce import assemble, disassemble, reduce_dim


def reduced(X: np.ndarray, labels: np.ndarray, method: str, device=None) -> np.ndarray:
    """process_bc.py:37-40's normalisation (scale to unit max-abs) and
    labels (fitness rounded to hundreds, LDA's classes), then the method."""
    X_n = X / max(np.abs(X).max(), 1e-9)
    return reduce_dim(X_n, labels=np.ravel(np.round(labels / 100)), method=method, device=device)


def process(
    start_iter: int,
    end_iter: int,
    path: str,
    bc_dim: int,
    method: str = "pca",
    ds_ratio: float = 1.0,
    device=None,
) -> str:
    X, p_opt, ch_opt, num_os, labels = assemble(start_iter, end_iter, path, bc_dim=bc_dim, ds_ratio=ds_ratio)
    X_r = reduced(X, labels, method, device)
    return disassemble(
        X_r, p_opt, ch_opt, method, start_iter=start_iter, end_iter=end_iter, path=path, chunk=1 + num_os,
    )


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="deep_neuroevolution_torch.inspector.process_bc")
    p.add_argument("start_iter", type=int)
    p.add_argument("end_iter", type=int)
    p.add_argument("path", help="log dir containing snapshots/ with hi-dim BCs")
    p.add_argument("bc_dim", type=int, help="dimension of the stored BCs")
    p.add_argument("--method", default="pca", choices=["pca", "tsne", "lda", "downsampling", "two_end"])
    p.add_argument("--ds_ratio", type=float, default=1.0, help="offspring downsampling ratio before reduction")
    p.add_argument("--device", default="cuda", help="where 'pca' runs (cuda or cpu)")
    args = p.parse_args(argv)
    out = process(args.start_iter, args.end_iter, args.path, args.bc_dim, method=args.method,
                  ds_ratio=args.ds_ratio, device=args.device)
    print(out)
    return out


if __name__ == "__main__":
    main()
