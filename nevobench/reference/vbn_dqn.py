"""Plain reference of the ES policy, ModelVirtualBN (Salimans et al. 2017,
arXiv:1703.03864; uber-research/deep-neuroevolution
gpu_implementation/neuroevolution/models/batchnorm.py).

84×84×4 frames → conv16 8×8/4 → conv32 4×4/2 → fc256 → actions, bias-free
layers, relu. After each of the first three layers, virtual batch norm:
x̂ = (h − μ)/√(σ² + 1e-3) + b, with μ and σ² the member's own moments of
its forward of the reference batch, over batch and spatial axes for a conv
and over the batch for the fc. The out layer has weights and a bias.

Everything here is float32, the convs in NCHW on ``F.conv2d``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .common import Spec, nhwc_flatten, pop_conv, pop_linear, unflatten

EPS = 1e-3


def layout(cfg: dict) -> List[Spec]:
    """The flat θ layout of the published model: each layer's weight, then
    its normalization bias."""
    c1, c2, fc, a = cfg["conv1_channels"], cfg["conv2_channels"], cfg["fc_units"], cfg["num_actions"]
    k1, k2 = cfg["conv1_kernel"], cfg["conv2_kernel"]
    h2 = cfg["conv2_out_hw"]
    return [
        ("conv1/w", (k1, k1, cfg["in_ch"], c1), "normc", 1.0), ("conv1/bn_b", (c1,), "zeros", 0.0),
        ("conv2/w", (k2, k2, c1, c2), "normc", 1.0), ("conv2/bn_b", (c2,), "zeros", 0.0),
        ("fc/w", (h2 * h2 * c2, fc), "normc", 1.0), ("fc/bn_b", (fc,), "zeros", 0.0),
        ("out/w", (fc, a), "normc", cfg["out_std"]), ("out/b", (a,), "zeros", 0.0),
    ]


def _moments(h: torch.Tensor, dims: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = h.mean(dim=dims)
    var = ((h - mean.reshape(_bshape(mean, h.ndim))) ** 2).mean(dim=dims)
    return mean, 1.0 / torch.sqrt(var + EPS)


def _bshape(stat: torch.Tensor, ndim: int) -> Tuple[int, ...]:
    """A ``[B, C]`` statistic's shape against ``[N, B, C, (H, W)]``."""
    return (1,) + tuple(stat.shape) + (1,) * (ndim - 3)


def _norm(h: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    s = _bshape(mean, h.ndim)
    return torch.relu((h - mean.reshape(s)) * inv.reshape(s) + bias.reshape(s))


def _forward(w: dict, x: torch.Tensor, cfg: dict, stats):
    """x ``[N, B, 4, 84, 84]`` → scores ``[N, B, A]``; ``stats`` None takes
    the moments of this batch (the reference-batch pass) and returns them."""
    out_stats = []
    s1, s2 = cfg["conv1_stride"], cfg["conv2_stride"]
    h = pop_conv(x, w["conv1/w"], s1)
    for i, (name, nxt, stride) in enumerate((("conv1", "conv2/w", s2), ("conv2", None, 0))):
        mean, inv = _moments(h, (0, 3, 4)) if stats is None else stats[i]
        out_stats.append((mean, inv))
        x = _norm(h, mean, inv, w[f"{name}/bn_b"])
        if nxt is not None:
            h = pop_conv(x, w[nxt], stride)
    h = pop_linear(nhwc_flatten(x), w["fc/w"])
    mean, inv = _moments(h, (0,)) if stats is None else stats[2]
    out_stats.append((mean, inv))
    x = _norm(h, mean, inv, w["fc/bn_b"])
    return pop_linear(x, w["out/w"]) + w["out/b"][None], out_stats


def ref_stats(w: dict, ref_batch: torch.Tensor, cfg: dict, chunk: int = 64):
    """Each member's moments over its forward of ``ref_batch`` ``[R, 4, 84,
    84]``: three (μ, 1/σ) pairs, each ``[B, C]``, ``chunk`` members at a
    time."""
    B = w["conv1/w"].shape[0]
    parts = []
    for s in range(0, B, chunk):
        wc = {k: v[s:s + chunk] for k, v in w.items()}
        n = wc["conv1/w"].shape[0]
        x = ref_batch[:, None].expand(-1, n, -1, -1, -1)
        parts.append(_forward(wc, x, cfg, None)[1])
    return [tuple(torch.cat([p[i][j] for p in parts]) for j in range(2)) for i in range(3)]


def scorer(thetas: torch.Tensor, ref_batch: torch.Tensor, cfg: dict):
    """The scores of members ``thetas`` ``[B, D]``, their moments worked out
    from ``ref_batch`` first: a function of stacks ``[P, B, 4, 84, 84]``
    (member b sees stacks[:, b]) → ``[P, B, A]``."""
    w = unflatten(thetas, layout(cfg))
    stats = ref_stats(w, ref_batch, cfg)
    return lambda stacks: _forward(w, stacks, cfg, stats)[0]
