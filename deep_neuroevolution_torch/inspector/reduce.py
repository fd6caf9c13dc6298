"""Hi-dimensional BC reduction pipeline: assemble → reduce → disassemble.

The port's copy of the JAX package's inspector/reduce.py (after
visual_inspector/process_bc.py:19-53 and dimen_red/{assemble.py, reduce.py,
disassemble.py}): stack parent and offspring BC rows over a generation
range, reduce them to 2-D, and write reduced .dat files per generation
with the trailing option columns kept. ``assemble`` (its ``default_rng(0)``
downsampling draw included) and ``disassemble`` (the files byte for byte)
are the JAX package's.

Methods of ``reduce_dim``:

* 'downsampling' and 'two_end': exact, numpy;
* 'pca': scikit-learn's ``PCA(n_components=2).fit_transform`` computed in
  float64 torch on ``device`` (default cuda; ``NoCudaDevice`` without a
  card, never the CPU behind the caller's back): the same centring, the
  same decomposition as scikit-learn 1.9's 'auto' solver picks it (the
  covariance's eigenvectors for tall, narrow inputs, at most 1000 columns
  and at least 10 rows a column; else the SVD of the centred rows), and
  the same signs (``svd_flip`` on the components: each one's entry of
  largest magnitude positive). Where scikit-learn picks its randomized
  solver (more than 500 rows or columns, neither tall nor narrow), the
  port computes the exact SVD that solver approximates;
* 'tsne' and 'lda': scikit-learn's, imported when asked for; where it is
  missing they raise an ``ImportError`` that names the method.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .load_data import _gen_dir


def assemble(
    start_iter: int,
    end_iter: int,
    path: str,
    *,
    bc_dim: int,
    ds_ratio: float = 1.0,
    rng: Optional[np.random.Generator] = None,
):
    """Stack [parent_bc; offspring_bcs] per generation (assemble.py:5-37).
    Returns (X, parent_options, child_options, num_os_per_gen, labels)."""
    rng = rng or np.random.default_rng(0)
    X, parent_options, child_options, labels = [], [], [], []
    num_os = 0
    for gen in range(start_iter, end_iter + 1):
        pdata = np.loadtxt(os.path.join(_gen_dir(path, gen), f"snapshot_parent_{gen:04d}.dat"))
        X.append(pdata[:bc_dim][None, :])
        parent_options.append(pdata[bc_dim:])
        labels.append(pdata[bc_dim : bc_dim + 1][None, :])

        odata = np.loadtxt(os.path.join(_gen_dir(path, gen), f"snapshot_offspring_{gen:04d}.dat"), ndmin=2)
        n = odata.shape[0]
        selected = np.arange(n)
        if n >= 10 and ds_ratio < 1.0:
            selected = rng.permutation(n)[: max(10, int(n * ds_ratio))]
        X.append(odata[selected, :bc_dim])
        child_options.append(odata[selected, bc_dim:])
        labels.append(odata[selected, bc_dim : bc_dim + 1])
        num_os = len(selected)
    return np.vstack(X), parent_options, child_options, num_os, np.vstack(labels)


def pca_solver(n_samples: int, n_features: int) -> str:
    """The solver scikit-learn 1.9's ``PCA(n_components=2)`` picks for a
    dense input of this shape (``PCA._fit``, svd_solver='auto')."""
    if n_features <= 1_000 and n_samples >= 10 * n_features:
        return "covariance_eigh"
    if max(n_samples, n_features) <= 500:
        return "full"
    if 2 < 0.8 * min(n_samples, n_features):
        return "randomized"
    return "full"


def pca(X: np.ndarray, device=None) -> np.ndarray:
    """``PCA(n_components=2).fit_transform(X)`` in float64 on ``device``
    (see the module docstring); returns a float64 numpy array [n, 2]."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    n, d = X.shape
    if min(n, d) < 2:
        raise ValueError(f"pca needs at least 2 rows and 2 columns, got {X.shape}")
    x = torch.as_tensor(np.asarray(X, np.float64), device=dev)
    mean = x.mean(dim=0)
    if pca_solver(n, d) == "covariance_eigh":
        # C = (XᵀX − n·μμᵀ) / (n − 1), its eigenvectors largest first, and
        # the rows projected as X·Vᵀ − μ·Vᵀ (PCA._fit_full, _transform)
        cov = (x.T @ x - n * mean[:, None] * mean[None, :]) / (n - 1)
        vt = torch.linalg.eigh(cov)[1].flip(1).T[:2]
        vt = vt * _flip_signs(vt)[:, None]
        out = x @ vt.T - mean[None, :] @ vt.T
    else:
        # the centred rows' SVD, U·S of the first two (PCA._fit_full)
        u, s, vt = torch.linalg.svd(x - mean, full_matrices=False)
        signs = _flip_signs(vt[:2])
        out = u[:, :2] * signs[None, :] * s[:2]
    return out.cpu().numpy()


def _flip_signs(vt):
    """``svd_flip(u_based_decision=False)``: the sign of each row's entry of
    largest magnitude (the first such entry)."""
    import torch

    cols = vt.abs().argmax(dim=1)
    return torch.sign(vt[torch.arange(vt.shape[0], device=vt.device), cols])


def _sklearn(method: str):
    try:
        from sklearn import decomposition, discriminant_analysis, manifold
    except ImportError as e:
        raise ImportError(f"reduce_dim method {method!r} needs scikit-learn, which does not import here") from e
    return decomposition, discriminant_analysis, manifold


def reduce_dim(X: np.ndarray, *, labels: np.ndarray, method: str = "pca", device=None) -> np.ndarray:
    """2-D projection (dimen_red/reduce.py:6-31); ``device`` is 'pca''s."""
    if method == "downsampling":
        return X
    if method == "lda":
        _, discriminant_analysis, _ = _sklearn(method)
        X2 = X.copy()
        X2.flat[:: X.shape[1] + 1] += 0.01
        return discriminant_analysis.LinearDiscriminantAnalysis(n_components=2).fit_transform(X2, labels)
    if method == "tsne":
        decomposition, _, manifold = _sklearn(method)
        X_pca = decomposition.PCA(n_components=min(50, X.shape[1])).fit_transform(X)
        return manifold.TSNE(n_components=2, perplexity=min(30, max(5, X.shape[0] // 4)),
                             random_state=0).fit_transform(X_pca)
    if method == "pca":
        return pca(X, device)
    if method == "two_end":
        nrow, ncol = X.shape
        return np.hstack((X[:, int(ncol / 2 - 1)].reshape(nrow, 1), X[:, -1].reshape(nrow, 1)))
    raise NotImplementedError(method)


def disassemble(
    X_r: np.ndarray,
    parent_options: List[np.ndarray],
    child_options: List[np.ndarray],
    method: str,
    *,
    start_iter: int,
    end_iter: int,
    path: str,
    chunk: int,
) -> str:
    """Write reduced per-generation .dat files under `<path>_<method>/`
    (dimen_red/disassemble.py:10-41): same row layout with 2-D BCs."""
    out_root = f"{path}_{method}"
    for g_idx, gen in enumerate(range(start_iter, end_iter + 1)):
        rows = X_r[g_idx * chunk : (g_idx + 1) * chunk]
        out_dir = os.path.join(out_root, "snapshots", f"snapshot_gen_{gen:04d}")
        os.makedirs(out_dir, exist_ok=True)
        parent_row = np.hstack([rows[0], parent_options[g_idx]])
        np.savetxt(os.path.join(out_dir, f"snapshot_parent_{gen:04d}.dat"), parent_row[None, :], fmt="%.10g",
                   delimiter=" ")
        off_rows = np.hstack([rows[1:], child_options[g_idx]])
        np.savetxt(os.path.join(out_dir, f"snapshot_offspring_{gen:04d}.dat"), off_rows, fmt="%.10g", delimiter=" ")
    return out_root
