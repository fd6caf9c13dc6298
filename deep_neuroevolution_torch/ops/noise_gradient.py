"""K2: the ES gradient, g = Σᵢ wᵢ·table[idxᵢ : idxᵢ+dim].

``noise_gradient`` is the wrapper of the CUDA kernel in
csrc/noise_gradient.cu, which replaces the TPU kernel of the JAX package's
ops/pallas_kernels.py. Its plain version is ``fitness.gradient_from_noise``.

Offsets may be any value with ``0 <= idx`` and ``idx + dim <= len(table)``;
the wrapper checks that, and the kernel never reads past the last element of
a slice. None of the TPU kernel's alignment or tile-padding rules apply.
"""

from __future__ import annotations

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


def noise_gradient(table: torch.Tensor, idxs: torch.Tensor, weights: torch.Tensor, dim: int) -> torch.Tensor:
    """g [dim] f32. A CUDA tensor launches the kernel; a CPU tensor runs the
    plain version; any other device raises."""
    _check(table, idxs, weights, dim)
    if table.device.type == "cpu":
        return noise_gradient_plain(table, idxs, weights, dim)
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
