"""Novelty: mean distance to the k nearest points of a behavior archive.

The counterpart of the JAX package's ops/novelty.py, after
es_distributed/nses.py:12-32:

* ``euclidean_distance`` and ``compute_novelty_vs_archive``: the
  length-tolerant metric of ragged trajectory BCs (the overlapping prefix,
  then the shorter vector's last element against the longer one's tail,
  combined as √(a²+b²)) and its k-NN mean, on the host in float64. Copied
  as numpy code, so they match the JAX package's bit for bit.
* ``Archive``: a ``[capacity, bc_dim]`` float32 tensor on the trainer's
  device plus a count (a device int32 scalar), the reference's Redis list
  (dist.py:92-98). ``archive_add`` doubles the capacity when the archive is
  full and never drops a point; it reads the count on the host once an
  insert.
* ``novelty_vs_archive``: the k-NN mean for a batch of BCs, one distance
  matrix and one top-k. Rows at or past the count are +inf; with fewer
  than k points the mean runs over those that exist, the semantics of the
  reference's ``argsort()[:k]``.

The distances are ``sqrt(max(Σ(b − p)², 0))`` over the difference, as in
the JAX package, not ``torch.cdist``, whose matrix-product form
‖a‖² + ‖b‖² − 2a·b (its default past 25 rows) cancels badly on the maze's
coordinates in the hundreds. The JAX package runs this as XLA ops with no
Pallas kernel, so here it is plain torch ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def euclidean_distance(x: np.ndarray, y: np.ndarray) -> float:
    """Length-tolerant euclidean distance (nses.py:12-20), float64."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    n, m = len(x), len(y)
    if n > m:
        a = np.linalg.norm(y - x[:m])
        b = np.linalg.norm(y[-1] - x[m:])
    else:
        a = np.linalg.norm(x - y[:n])
        b = np.linalg.norm(x[-1] - y[n:])
    return float(np.sqrt(a**2 + b**2))


def compute_novelty_vs_archive(archive, novelty_vector, k: int) -> float:
    """Mean distance to the k nearest archive points (nses.py:22-32)."""
    distances = np.array([euclidean_distance(p, novelty_vector) for p in archive], np.float64)
    top_k = np.sort(distances)[:k]
    return float(top_k.mean())


class Archive(NamedTuple):
    points: torch.Tensor  # [capacity, bc_dim] f32; rows at or past count are unused
    count: torch.Tensor  # scalar int32 on the points' device


def archive_init(capacity: int, bc_dim: int, device=None) -> Archive:
    return Archive(torch.zeros((capacity, bc_dim), dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def archive_grow(a: Archive, factor: int = 2) -> Archive:
    """The archive at ``factor`` × its capacity, its points copied."""
    cap, bc_dim = a.points.shape
    points = torch.zeros((cap * factor, bc_dim), dtype=torch.float32, device=a.points.device)
    points[:cap] = a.points
    return Archive(points, a.count)


def archive_add(a: Archive, bc: torch.Tensor) -> Archive:
    """A new archive with ``bc`` appended (dist.py:92-94); ``a`` is left as
    it was, so a caller may keep it as a snapshot."""
    n = int(a.count)  # the host read, once an insert
    if n >= a.points.shape[0]:
        a = archive_grow(a)
    points = a.points.clone()
    points[n] = bc.to(points.device, torch.float32)
    return Archive(points, a.count + 1)


def novelty_vs_archive(a: Archive, bcs: torch.Tensor, k: int) -> torch.Tensor:
    """``bcs [B, bc_dim]`` → ``[B]``: each BC's mean distance to its k
    nearest archive points."""
    cap = a.points.shape[0]
    bcs = bcs.to(a.points.device, torch.float32)
    d = torch.sqrt(torch.clamp(torch.sum(torch.square(bcs[:, None, :] - a.points[None, :, :]), dim=-1), min=0.0))
    valid = torch.arange(cap, device=d.device) < a.count
    d = torch.where(valid[None, :], d, torch.inf)
    top = torch.topk(d, min(k, cap), dim=1, largest=False, sorted=True).values  # [B, k] ascending
    n_valid = torch.clamp(a.count, max=k)
    mask = torch.arange(top.shape[1], device=d.device)[None, :] < n_valid
    return torch.sum(torch.where(mask, top, 0.0), dim=1) / torch.clamp(n_valid, min=1).to(torch.float32)
