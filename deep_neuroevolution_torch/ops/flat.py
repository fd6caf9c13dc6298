"""Flat parameter-vector layout and initialization.

The counterpart of the JAX package's ops/flat.py:37-103. θ is one flat f32
vector; each named tensor is a static slice of it, in ParamSpec order. The
order and offsets are the JAX package's, so a θ vector moves between the
two packages unchanged (weights.from_jax).

Population use: ``unflatten`` also takes a stacked ``[B, D]`` θ and returns
``[B, *shape]`` views.

``scale_by_vector`` is the GPU stack's genome init scale (θ₀ = ε·scale_by;
the JAX package's flat.py:141-168), bit-exact with the JAX package's.
``partial_load`` is the warm start's surgery (flat.py:149 of the JAX
package). ``reinit_theta`` is the CPU stack's genome re-init (CPU-style
chains, flat.py:103-117 of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One named parameter tensor inside the flat vector."""

    name: str
    shape: Tuple[int, ...]
    init: str = "normc"  # 'normc' | 'zeros'
    std: float = 1.0

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))


def total_dim(specs: Sequence[ParamSpec]) -> int:
    return sum(s.size for s in specs)


def offsets(specs: Sequence[ParamSpec]) -> Dict[str, Tuple[int, int]]:
    """name → (offset, size) inside the flat vector."""
    out, off = {}, 0
    for s in specs:
        out[s.name] = (off, s.size)
        off += s.size
    return out


def unflatten(theta: torch.Tensor, specs: Sequence[ParamSpec]) -> Dict[str, torch.Tensor]:
    """Flat ``[..., D]`` → dict of ``[..., *shape]`` views (no copies)."""
    lead = tuple(theta.shape[:-1])
    parts, off = {}, 0
    for s in specs:
        parts[s.name] = theta[..., off : off + s.size].reshape(lead + tuple(s.shape))
        off += s.size
    return parts


def flatten(parts: Dict[str, torch.Tensor], specs: Sequence[ParamSpec]) -> torch.Tensor:
    """Inverse of ``unflatten`` for one member: dict → flat f32 ``[D]``."""
    return torch.cat([parts[s.name].reshape(-1).to(torch.float32) for s in specs])


def _normc(gen: torch.Generator, shape: Tuple[int, ...], std: float) -> torch.Tensor:
    """Normalized-column init: randn ``[fan_in, cols]`` columns rescaled to
    L2 norm ``std``, then reshaped (the reference's tf_util normc)."""
    flat_shape = (int(np.prod(shape[:-1])), shape[-1])
    out = torch.randn(flat_shape, generator=gen, dtype=torch.float32)
    out = out * (std / torch.sqrt(torch.sum(out * out, dim=0, keepdim=True)))
    return out.reshape(shape)


def init_theta(
    gen: torch.Generator, specs: Sequence[ParamSpec], device: Optional[torch.device] = None
) -> torch.Tensor:
    """Fresh flat θ with each spec's initializer, drawn from ``gen`` (a CPU
    generator, so a seed gives the same θ on every device)."""
    chunks = []
    for s in specs:
        if s.init == "normc":
            chunks.append(_normc(gen, s.shape, s.std).reshape(-1))
        elif s.init == "zeros":
            chunks.append(torch.zeros(s.size, dtype=torch.float32))
        else:
            raise ValueError(f"unknown init {s.init!r}")
    return torch.cat(chunks).to(device or "cpu")


def reinit_theta(theta: torch.Tensor, specs: Sequence[ParamSpec]) -> torch.Tensor:
    """The CPU stack's GA ``reinitialize`` (tf_util.py:122-130,
    es_distributed/ga.py:256-260) of ``[..., D]`` raw values: each weight
    tensor's columns of the existing values rescaled to L2 norm ``std``,
    biases zeroed. A new tensor; float32 sums, so it equals the JAX
    package's within float32 reordering."""
    lead = tuple(theta.shape[:-1])
    chunks = []
    for s, x in zip(specs, unflatten(theta, specs).values()):
        if s.init == "normc":
            cols = x.reshape(lead + (-1, s.shape[-1]))
            cols = cols * (s.std / torch.sqrt(torch.sum(cols * cols, dim=-2, keepdim=True)))
            chunks.append(cols.reshape(lead + (-1,)))
        else:
            chunks.append(torch.zeros(lead + (s.size,), dtype=theta.dtype, device=theta.device))
    return torch.cat(chunks, dim=-1)


def default_scale_by(spec: ParamSpec, style: str = "fan_in") -> float:
    """Per-parameter genome scale for GPU-style seed reconstruction.

    style='fan_in' — gpu dqn.py:26-28: std/√(prod(shape[:-1])) for weights.
    style='base'   — gpu base.py:46-49: std·√((shape[-2]+shape[-1])·prod(shape[:-2])/2).
    Biases always 0 (base.py:50-52)."""
    if spec.init == "zeros":
        return 0.0
    shape = spec.shape
    if style == "fan_in":
        return spec.std / float(np.sqrt(np.prod(shape[:-1])))
    if style == "base":
        factor = (shape[-2] + shape[-1]) * float(np.prod(shape[:-2], dtype=np.float64) if len(shape) > 2 else 1.0) / 2.0
        return spec.std * float(np.sqrt(factor))
    raise ValueError(f"unknown scale_by style {style!r}")


def scale_by_vector(
    specs: Sequence[ParamSpec], style: str = "fan_in", device: Optional[torch.device] = None
) -> torch.Tensor:
    """The per-element scale vector ``[D]`` f32 (base.py:166-175): each
    spec's scale, rounded once to float32, repeated over its elements."""
    return torch.cat(
        [torch.full((s.size,), default_scale_by(s, style), dtype=torch.float32) for s in specs]
    ).to(device or "cpu")


def partial_load(theta_big: torch.Tensor, specs_big: Sequence[ParamSpec], parts_small) -> torch.Tensor:
    """Warm-start surgery (policies.py:219-249 ``initialize_from``): each of a
    smaller policy's arrays (name → numpy array or tensor, the larger
    model's names) goes into the prefix slice of the larger one's tensor of
    that name; everything else keeps ``theta_big``'s values. Returns a new
    flat θ on ``theta_big``'s device."""
    parts = {k: v.clone() for k, v in unflatten(theta_big.detach(), specs_big).items()}
    for name, small in parts_small.items():
        small = small.detach().float() if torch.is_tensor(small) else torch.from_numpy(np.array(small, np.float32))
        big = parts[name]
        if small.ndim != big.ndim or any(b < s for b, s in zip(big.shape, small.shape)):
            raise ValueError(f"{name}: a {tuple(small.shape)} array does not fit the prefix of {tuple(big.shape)}")
        big[tuple(slice(0, d) for d in small.shape)] = small.to(big.device)
    return flatten(parts, specs_big)
