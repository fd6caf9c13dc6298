"""K1: the population fc layer, y[b] = x[b]·W[b].

``population_linear`` is the wrapper of the CUDA kernel in
csrc/population_linear.cu, which replaces the TPU kernel of the JAX
package's ops/pallas_forward.py. ``population_linear_plain`` is its plain
PyTorch version: the CPU path and the yardstick the kernel is held to on
the card.

x ``[B, K]`` and W ``[B, K, N]`` are both float32 or both bfloat16; y is
``[B, N]`` float32, accumulated in float32. Any B, K and N.
"""

from __future__ import annotations

import torch

from . import _cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def population_linear_plain(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bk,bkn->bn", x.float(), W.float())


def _check(x: torch.Tensor, W: torch.Tensor) -> None:
    if x.ndim != 2 or W.ndim != 3 or tuple(x.shape) != tuple(W.shape[:2]):
        raise ValueError(f"population_linear needs x [B, K] and W [B, K, N], got {tuple(x.shape)}, {tuple(W.shape)}")
    if x.dtype != W.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x and W must both be float32 or both bfloat16, got {x.dtype}, {W.dtype}")
    if x.device != W.device:
        raise ValueError(f"x and W on different devices: {x.device}, {W.device}")
    if not (x.is_contiguous() and W.is_contiguous()):
        raise ValueError("population_linear needs contiguous x and W")


def population_linear(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b]·W[b]. A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version; any other device raises."""
    _check(x, W)
    if x.device.type == "cpu":
        return population_linear_plain(x, W)
    if x.device.type != "cuda":
        raise ValueError(f"population_linear runs on cuda or cpu tensors, not {x.device}")
    B, K, N = W.shape
    y = torch.empty((B, N), dtype=torch.float32, device=x.device)
    if B == 0 or N == 0:
        return y
    lib = _cuda_build.load()
    err = lib.nevo_population_linear(
        x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, _DTYPE_CODE[x.dtype],
        _cuda_build.current_stream(x.device),
    )
    _cuda_build.check(lib, err, "population_linear")
    population_linear.launches += 1
    return y


population_linear.launches = 0  # kernel launches since the caller last set it to 0
