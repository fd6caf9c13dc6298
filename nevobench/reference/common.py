"""Plain PyTorch pieces shared by the references: the parameter layout, the
frame preprocessing, a population conv with TF-style SAME padding, and the
rounding of operands to bfloat16 or float8.

Nothing here imports the program. Images are NCHW here (``F.conv2d``'s
layout), where the program keeps NHWC and im2col patches; flat θ and the fc
rows follow the published TF layout: conv weights HWIO, the fc's rows in
(h, w, c) order of the NHWC flatten.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# One parameter tensor inside flat θ: (name, shape, init, std). Every
# weight is 'normc' (columns of the last axis scaled to L2 norm std), every
# bias 'zeros'.
Spec = Tuple[str, Tuple[int, ...], str, float]


def use_exact_float32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def total_dim(specs: Sequence[Spec]) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in specs)


def unflatten(thetas: torch.Tensor, specs: Sequence[Spec]) -> Dict[str, torch.Tensor]:
    """``[B, D]`` → name → ``[B, *shape]`` views, in layout order."""
    out, off = {}, 0
    for name, shape, _, _ in specs:
        n = math.prod(shape)
        out[name] = thetas[:, off:off + n].reshape((thetas.shape[0],) + tuple(shape))
        off += n
    if off != thetas.shape[1]:
        raise ValueError(f"θ has {thetas.shape[1]} values, the layout {off}")
    return out


def init_scale(specs: Sequence[Spec], style: str) -> List[Tuple[int, int, float]]:
    """(offset, size, scale) of each tensor for a Gaussian draw: ``fan_in``
    gives a weight std/√fan_in (the GPU stack's genome scale), a bias 0."""
    if style != "fan_in":
        raise ValueError(f"unknown init style {style!r}")
    out, off = [], 0
    for _, shape, init, std in specs:
        n = math.prod(shape)
        out.append((off, n, std / math.sqrt(math.prod(shape[:-1])) if init == "normc" else 0.0))
        off += n
    return out


def normc_(thetas: torch.Tensor, specs: Sequence[Spec]) -> torch.Tensor:
    """Scale every weight's columns of ``thetas`` ``[B, D]`` (a Gaussian
    draw) to L2 norm std and zero every bias, in place: tf_util's normc."""
    for (name, shape, init, std), part in zip(specs, unflatten(thetas, specs).values()):
        cols = part.reshape(thetas.shape[0], -1, shape[-1])
        if init == "normc":
            cols.mul_(std / cols.square().sum(dim=1, keepdim=True).sqrt())
        else:
            cols.zero_()
    return thetas


# ------------------------------------------------------------------ rounding

def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x (float32) rounded to ``precision`` ('bfloat16', 'float8_e4m3') and
    returned as float32."""
    if precision == "bfloat16":
        return x.to(torch.bfloat16).float()
    if precision == "float8_e4m3":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {precision!r}")


# ------------------------------------------------------------ preprocessing

def _interp(in_size: int, out_size: int) -> torch.Tensor:
    """``[out, in]`` bilinear interpolation with aligned corners: output i
    samples input i·(in − 1)/(out − 1)."""
    m = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        src = i * (in_size - 1) / (out_size - 1)
        lo = min(int(math.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        m[i, lo] += 1.0 - (src - lo)
        m[i, hi] += src - lo
    return torch.from_numpy(m.astype(np.float32))


def preprocess_gray(frames: torch.Tensor, out_hw: int = 84) -> torch.Tensor:
    """uint8 gray frame pairs ``[N, 2, H, W]`` → ``[N, out_hw, out_hw]``
    float32: the pair's max, scaled to [0, 1], resized with aligned corners
    (the reference's tf_atari.py:90-94 after the palette)."""
    gray = frames.max(dim=1).values.float() / 255.0
    rows = _interp(frames.shape[2], out_hw).to(frames.device)
    cols = _interp(frames.shape[3], out_hw).to(frames.device).T.contiguous()
    return rows @ gray @ cols


def stacks_of(pre: torch.Tensor, order: Sequence[Sequence[int]]) -> torch.Tensor:
    """The 4-frame stacks ``[P, N, 4, h, w]`` (oldest first) of positions
    ``order``, each a list of 4 indices into the preprocessed frames
    ``pre`` ``[R, N, h, w]``, −1 for the zero history of an episode's first
    steps."""
    zero = torch.zeros_like(pre[0])
    return torch.stack([torch.stack([pre[i] if i >= 0 else zero for i in idx], dim=1) for idx in order])


# -------------------------------------------------------------------- convs

def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME padding (low, high), the odd element on the high side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pop_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Each member's conv of its own images: x ``[N, B, C, H, W]`` (N
    images a member), w ``[B, k, k, C, O]`` HWIO → ``[N, B, O, H', W']``,
    SAME padding, as one grouped ``F.conv2d`` in float32."""
    n, b, c, h, wd = x.shape
    k, o = w.shape[1], w.shape[4]
    pt, pb = same_pads(h, k, stride)
    pl, pr = same_pads(wd, k, stride)
    xp = F.pad(x.reshape(n, b * c, h, wd), (pl, pr, pt, pb))
    wk = w.permute(0, 4, 3, 1, 2).reshape(b * o, c, k, k).contiguous()
    y = F.conv2d(xp, wk, stride=stride, groups=b)
    return y.reshape(n, b, o, y.shape[2], y.shape[3])


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """``[N, B, C, H, W]`` → ``[N, B, H·W·C]`` in (h, w, c) order, the fc's
    row order."""
    return x.permute(0, 1, 3, 4, 2).reshape(x.shape[0], x.shape[1], -1)


def pop_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x ``[N, B, K]``, w ``[B, K, M]`` → ``[N, B, M]``: member b's rows
    times its own matrix, in float32."""
    y = torch.bmm(x.transpose(0, 1).contiguous(), w)
    return y.transpose(0, 1)
