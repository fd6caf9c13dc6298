"""K2: the ES gradient, g = Σᵢ wᵢ·table[idxᵢ : idxᵢ+dim].

``noise_gradient`` is the wrapper of the CUDA kernel in
csrc/noise_gradient.cu, which replaces the TPU kernel of the JAX package's
ops/pallas_kernels.py. Its plain version is ``fitness.gradient_from_noise``.

Offsets may be any value with ``0 <= idx`` and ``idx + dim <= len(table)``;
the wrapper checks that, and the kernel never reads past the last element of
a slice. None of the TPU kernel's alignment or tile-padding rules apply: any
view of a table will do.

``plan`` and ``sorted_pairs`` are the kernel's geometry in Python, for the
CPU tests: which outputs each block sums and each of its threads holds, and
in which order, sorted how many pairs at a time, every block walks the pairs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _cuda_build
from .fitness import gradient_from_noise as noise_gradient_plain  # noqa: F401


def _check(table: torch.Tensor, idxs: torch.Tensor, weights: torch.Tensor, dim: int) -> None:
    if table.ndim != 1 or table.dtype != torch.float32:
        raise TypeError(f"table must be a 1-D float32 tensor, got {table.dtype} {tuple(table.shape)}")
    if idxs.ndim != 1 or idxs.dtype != torch.int32:
        raise TypeError(f"idxs must be a 1-D int32 tensor, got {idxs.dtype} {tuple(idxs.shape)}")
    if weights.ndim != 1 or weights.dtype != torch.float32 or weights.shape != idxs.shape:
        raise TypeError(f"weights must be float32 of idxs' shape, got {weights.dtype} {tuple(weights.shape)}")
    if not (table.device == idxs.device == weights.device):
        raise ValueError(f"table, idxs and weights on different devices: {table.device}, {idxs.device}, {weights.device}")
    if not (table.is_contiguous() and idxs.is_contiguous() and weights.is_contiguous()):
        raise ValueError("noise_gradient needs contiguous table, idxs and weights")
    if dim < 0 or dim > table.shape[0]:
        raise ValueError(f"dim={dim} outside [0, {table.shape[0]}]")
    if idxs.numel():
        lo, hi = (int(v) for v in torch.aminmax(idxs))
        if lo < 0 or hi + dim > table.shape[0]:
            raise IndexError(f"noise offsets [{lo}, {hi}] + dim={dim} outside table of {table.shape[0]}")


def noise_gradient(table: torch.Tensor, idxs: torch.Tensor, weights: torch.Tensor, dim: int,
                   chunk: int = 256) -> torch.Tensor:
    """g [dim] f32. A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version, which gathers ``chunk`` pairs' slices at a time (ES's
    ``grad_chunk``); any other device raises. The kernel has no chunk: it
    sorts and walks every pair in one launch, so ``chunk`` does not reach
    it."""
    _check(table, idxs, weights, dim)
    if table.device.type == "cpu":
        return noise_gradient_plain(table, idxs, weights, dim, chunk)
    if table.device.type != "cuda":
        raise ValueError(f"noise_gradient runs on cuda or cpu tensors, not {table.device}")
    g = torch.empty(dim, dtype=torch.float32, device=table.device)
    if dim == 0:
        return g
    lib = _cuda_build.load()
    err = lib.nevo_noise_gradient(
        table.data_ptr(), idxs.data_ptr(), weights.data_ptr(), idxs.shape[0], dim, g.data_ptr(),
        _cuda_build.current_stream(table.device),
    )
    _cuda_build.check(lib, err, "noise_gradient")
    noise_gradient.launches += 1
    return g


noise_gradient.launches = 0  # kernel launches since the caller last set it to 0


# The kernel's geometry; csrc/noise_gradient.cu has the same constants.
TILE_MAX = 8184  # outputs a block sums at a time
SORT_CAP = 8192  # pairs a block sorts at a time
THREADS, PER = 512, 16  # a block's threads; outputs a thread sums, THREADS apart


@dataclasses.dataclass(frozen=True)
class Plan:
    """Outputs are cut into ``tiles`` tiles of ``tile`` floats (the last
    shorter); block b of the ``grid`` sums tiles b, b + grid, ... (at most
    ``rounds``), each over every pair, the pairs sorted ``chunk`` at a time
    (``chunks`` chunks, in order)."""

    B: int
    D: int
    sm_count: int
    tile: int
    tiles: int
    grid: int
    rounds: int
    chunk: int
    chunks: int

    def tile_range(self, t: int) -> tuple:
        """Outputs [start, stop) of tile t."""
        return t * self.tile, min(self.D, (t + 1) * self.tile)

    def block_tiles(self, b: int) -> list:
        """The tiles block b sums, in its order."""
        return list(range(b, self.tiles, self.grid))

    def thread_outputs(self, t: int) -> np.ndarray:
        """[THREADS, PER]: the outputs of tile t that each thread sums
        (thread i's m-th is start + i + m·THREADS), -1 past the tile."""
        start, stop = self.tile_range(t)
        out = start + np.arange(THREADS)[:, None] + THREADS * np.arange(PER)[None]
        return np.where(out < stop, out, -1)


def plan(B: int, D: int, sm_count: int) -> Plan:
    """The kernel's geometry for B pairs and D outputs on ``sm_count`` SMs
    (the C entry point's ``geometry``)."""
    if D <= 0:
        return Plan(B, D, sm_count, 0, 0, 0, 0, SORT_CAP, 0)
    need = -(-D // TILE_MAX)  # tiles of at most TILE_MAX outputs
    rounds = -(-need // sm_count)
    tile = (-(-D // (rounds * sm_count)) + 3) & ~3
    tiles = -(-D // tile)
    return Plan(B, D, sm_count, tile, tiles, min(sm_count, tiles), rounds, SORT_CAP, -(-B // SORT_CAP))


def sorted_pairs(idxs: np.ndarray) -> np.ndarray:
    """The order in which every block walks the pairs: chunk by chunk of
    ``SORT_CAP``, each by (offset, pair index)."""
    idxs = np.asarray(idxs, np.int64)
    order = [c0 + np.lexsort((np.arange(len(idxs[c0:c0 + SORT_CAP])), idxs[c0:c0 + SORT_CAP]))
             for c0 in range(0, len(idxs), SORT_CAP)]
    return np.concatenate(order) if order else np.zeros(0, np.int64)

