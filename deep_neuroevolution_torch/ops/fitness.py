"""Fitness shaping and the plain ES gradient.

The counterpart of the JAX package's ops/fitness.py:28-100:

* ``compute_ranks`` / ``compute_centered_ranks`` — es_distributed/es.py:70-85:
  ranks in ``[0, n)`` by argsort, centered to ``[-0.5, 0.5]``. The sort is
  stable (``jnp.argsort`` is), so tied returns rank in index order in both
  packages.
* ``process_returns`` — the modes of es.py:281-288.
* ``gradient_from_noise`` — g = Σᵢ wᵢ·table[idxᵢ : idxᵢ+dim], streamed in
  chunks of rows so the ``[n, dim]`` noise matrix never exists. On a table
  it is the plain version of the CUDA kernel in ops/noise_gradient.py; on a
  ``VirtualNoise`` it regenerates the rows, ``chunk`` at a time, as the JAX
  package's does (fitness.py:75-105), and no kernel takes part.
"""

from __future__ import annotations

import torch

from .noise import noise_rows


def compute_ranks(x: torch.Tensor) -> torch.Tensor:
    """Ranks in ``[0, len(x))`` (es.py:70-78; not scipy's 1-based ranks)."""
    if x.ndim != 1:
        raise ValueError(f"compute_ranks takes a 1-D tensor, got shape {tuple(x.shape)}")
    order = torch.argsort(x, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(x.shape[0], device=x.device, dtype=order.dtype)
    return ranks


def compute_centered_ranks(x: torch.Tensor) -> torch.Tensor:
    """Rank transform to ``[-0.5, 0.5]``, keeping the input's shape."""
    ranks = compute_ranks(x.reshape(-1)).reshape(x.shape).to(torch.float32)
    return ranks / (x.numel() - 1) - 0.5


def process_returns(returns: torch.Tensor, signreturns: torch.Tensor, mode: str) -> torch.Tensor:
    """``returns``/``signreturns`` are ``[n, 2]`` antithetic columns (pos, neg)."""
    if mode == "centered_rank":
        return compute_centered_ranks(returns)
    if mode == "sign":
        return signreturns.to(torch.float32)
    if mode == "centered_sign_rank":
        return compute_centered_ranks(signreturns)
    raise NotImplementedError(f"unknown return_proc_mode {mode!r}")


def gradient_from_noise(
    table,  # [N] f32 noise table tensor, or a noise source (ops/noise.py)
    idxs: torch.Tensor,  # [n] int start offsets (stream ids for a VirtualNoise)
    weights: torch.Tensor,  # [n] f32 per-pair weights (w⁺ − w⁻)
    dim: int,
    chunk: int = 256,
) -> torch.Tensor:
    """g = Σᵢ wᵢ·εᵢ in f32, ``chunk`` rows at a time (peak memory
    chunk·dim·4 bytes instead of n·dim·4), on the source's device; εᵢ is
    ``noise_rows(table, idxᵢ)``: ``table[idxᵢ : idxᵢ+dim]``, or a
    VirtualNoise's row regenerated."""
    if isinstance(table, torch.Tensor) and table.ndim != 1:
        raise ValueError(f"table must be 1-D with at least dim={dim} entries")
    weights = weights.to(device=table.device, dtype=torch.float32)
    g = torch.zeros(dim, dtype=torch.float32, device=table.device)
    for s in range(0, idxs.shape[0], chunk):
        g += weights[s : s + chunk] @ noise_rows(table, idxs[s : s + chunk], dim)
    return g
