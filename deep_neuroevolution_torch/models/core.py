"""Policy model base: networks as functions of a flat θ vector.

The counterpart of the JAX package's models/core.py. Layouts are the JAX
package's so the two compare like with like: images are NHWC, conv weights
HWIO, and im2col patches have (i, j, c) feature order, matching an HWIO
weight reshaped to ``[k·k·C, O]``.

A population forward evaluates B members, each with its own θ, on its own
frame. The conv layers are batched matrix products over im2col patches;
the fc layer, which holds most of the weight bytes, goes through
``pop_matvec`` (kernel K1 on a CUDA tensor). The MLPs' layers go through
``dense``, a batched product on the library (the JAX package lowers its
``jax.vmap`` of ``x @ w`` to a batched GEMM outside any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..ops import flat
from ..ops.flat import ParamSpec
from ..ops.population_linear import population_linear


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF SAME padding: total = max((ceil(size/s)−1)·s + k − size, 0), split
    low/high with the extra element on the high side."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def extract_patches(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``[N, H, W, C]`` → ``[N, H', W', k·k·C]`` im2col patches with SAME
    padding, feature order (i, j, c)."""
    (pt, pb), (pl, pr) = _same_pads(x.shape[1], k, stride), _same_pads(x.shape[2], k, stride)
    x = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    n, c = x.shape[0], x.shape[3]
    p = x.unfold(1, k, stride).unfold(2, k, stride)  # [N, H', W', C, i, j]
    h2, w2 = p.shape[1], p.shape[2]
    return p.permute(0, 1, 2, 4, 5, 3).reshape(n, h2, w2, k * k * c)


def batch_conv2d(
    w: torch.Tensor,  # [B, k, k, cin, cout] per-member HWIO weights
    x: torch.Tensor,  # [B, H, W, cin]
    stride: int,
) -> torch.Tensor:
    """Population conv: every member convolves its frame with its weights,
    as one batched product ``[B, P, K]·[B, K, O]``. Products of bfloat16
    inputs are summed in float32; the result is float32 ``[B, H', W', O]``."""
    B, kh, kw, cin, cout = w.shape
    patches = extract_patches(x, kh, stride)
    _, h2, w2, kk = patches.shape
    y = torch.bmm(patches.reshape(B, h2 * w2, kk).float(), w.reshape(B, kk, cout).float())
    return y.reshape(B, h2, w2, cout)


def pop_matvec(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b]·W[b], ``[B, K]·[B, K, N]`` → ``[B, N]`` float32: the
    population's fc layer. Kernel K1 on a CUDA tensor, its plain version on
    a CPU tensor (ops/population_linear.py)."""
    return population_linear(x, W)


def dense(parts: Dict[str, torch.Tensor], name: str, x: torch.Tensor) -> torch.Tensor:
    """Population dense layer: ``[B, K]·[B, K, N] + [B, N]`` for the stacked
    parts ``{name}/w`` and ``{name}/b`` (tf_util.py:150-162), float32."""
    return torch.bmm(x[:, None, :], parts[f"{name}/w"])[:, 0] + parts[f"{name}/b"]


def _elu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.elu: x where x > 0, else expm1(x)."""
    return torch.where(x > 0, x, torch.expm1(torch.clamp(x, max=0.0)))


NONLINS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "lrelu": lambda x: torch.maximum(x, 0.2 * x),  # tf_util lrelu, leak 0.2
    "elu": _elu,
}


@dataclasses.dataclass(frozen=True)
class Model:
    """Base for all policies. Subclasses define ``build_specs`` and
    ``batch_act_parts``."""

    def __post_init__(self):
        object.__setattr__(self, "_specs", tuple(self.build_specs()))

    @property
    def specs(self) -> Tuple[ParamSpec, ...]:
        return self._specs

    @property
    def num_params(self) -> int:
        return flat.total_dim(self.specs)

    def build_specs(self) -> Sequence[ParamSpec]:
        raise NotImplementedError

    def init_theta(self, gen: torch.Generator, device: Optional[torch.device] = None) -> torch.Tensor:
        """Fresh flat θ with each layer's initializer."""
        return flat.init_theta(gen, self.specs, device)

    def scale_by(self, style: str = "fan_in", device: Optional[torch.device] = None) -> torch.Tensor:
        """``[D]`` per-element genome init scale (base.py:166-175)."""
        return flat.scale_by_vector(self.specs, style, device)

    def unflatten(self, theta: torch.Tensor) -> Dict[str, torch.Tensor]:
        return flat.unflatten(theta, self.specs)

    def prepare_parts(self, parts: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Per-rollout post-processing of stacked ``[B, ...]`` parts (casts,
        contiguous copies), done once outside the step loop."""
        return parts

    def prepare_batch_params(self, params):
        """``(thetas [B, D], ctx)`` → ``(parts dict, ctx)``. Runs once per
        rollout so the step loop reads prepared weights. Prepared params
        (a parts dict) pass through unchanged."""
        thetas, ctx = params
        if isinstance(thetas, dict):
            return params
        return self.prepare_parts(self.unflatten(thetas)), ctx

    def batch_act_parts(self, parts, obs: torch.Tensor, ctx) -> torch.Tensor:
        """Population action selection from stacked parts → actions ``[B]``."""
        raise NotImplementedError

    def make_batch_act(self):
        """act_fn for the rollout engine: ``(params, obs [B, ...]) →
        actions [B]``. It carries a ``prepare`` attribute that the rollout
        calls once before its step loop."""

        def batch_act(params, obs):
            parts, ctx = self.prepare_batch_params(params)
            return self.batch_act_parts(parts, obs, ctx)

        batch_act.prepare = self.prepare_batch_params
        return batch_act

    @property
    def needs_ref_batch(self) -> bool:
        return False

    @property
    def needs_ob_stat(self) -> bool:
        """Whether the forward normalizes observations by running stats
        that ride in its context (policies.py:211-213)."""
        return False
