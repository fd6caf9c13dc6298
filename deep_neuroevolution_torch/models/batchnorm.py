"""Virtual-batch-norm small DQN (ModelVirtualBN), split route.

The counterpart of the JAX package's models/batchnorm.py ``VirtualBNDQN``
with ``affine='bias'`` (the GPU stack's ModelVirtualBN,
gpu neuroevolution/models/batchnorm.py:52-123): bias-free
conv16(8,4) → conv32(4,2) → fc256 → out, and after each of the first three
layers a per-member normalization x̂ = (x − μ)·inv_σ + b, where μ and
inv_σ = 1/√(var + 1e-3) are the moments of the member's own forward of the
reference batch over batch and spatial axes, and b is a learned bias.

The population forward (``batch_scores_parts``) runs the convs as batched
products over im2col patches and the fc layer through ``pop_matvec``
(kernel K1 on a CUDA tensor). ``compute_dtype="bfloat16"`` runs the conv
and fc products on bfloat16 weights and activations with float32 sums;
θ, the moments and the normalization stay float32. Where the JAX package
rounds a product's output to the compute dtype (the reference-batch pass),
the port rounds it too.

Not ported yet: the 'full' (γ/β) affine, other nonlinearities, BNDQN, and
the fused, fused1 and folded routes.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple, Sequence, Tuple

import torch

from ..ops.flat import ParamSpec
from .core import Model, batch_conv2d, extract_patches, pop_matvec

VBN_EPS = 1e-3  # batchnorm.py:76; policies.py:322 epsilon=1e-3
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _conv_out_hw(hw: int, k: int, s: int) -> int:
    return -(-hw // s)  # SAME padding


class VBNStats(NamedTuple):
    mean: Tuple[torch.Tensor, ...]  # per normalized layer, [B, C]
    inv_std: Tuple[torch.Tensor, ...]


def _moments(h: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    mean = h.mean(dim=dims)
    var = h.var(dim=dims, correction=0)
    return mean, 1.0 / torch.sqrt(var + VBN_EPS)


@dataclasses.dataclass(frozen=True)
class VirtualBNDQN(Model):
    num_actions: int = 0
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'

    IN_HW: ClassVar[int] = 84  # input frames [84, 84, 4]
    IN_CH: ClassVar[int] = 4
    OUT_STD: ClassVar[float] = 1.0  # batchnorm.py:110 dense('out') default std
    LAYERS: ClassVar[Tuple[Tuple[str, int, int, int], ...]] = (("conv1", 16, 8, 4), ("conv2", 32, 4, 2))
    FC: ClassVar[int] = 256
    # members whose reference-batch forwards are live at once in
    # batch_ref_stats: conv2's patches alone are R·121·256 floats per member
    REF_STATS_CHUNK: ClassVar[int] = 32

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        super().__post_init__()

    @property
    def needs_ref_batch(self) -> bool:
        return True

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def build_specs(self) -> Sequence[ParamSpec]:
        specs = []
        hw, ch = self.IN_HW, self.IN_CH
        for name, out_ch, k, s in self.LAYERS:
            specs.append(ParamSpec(f"{name}/w", (k, k, ch, out_ch), "normc", 1.0))
            specs.append(ParamSpec(f"{name}/bn_b", (out_ch,), "zeros"))
            hw, ch = _conv_out_hw(hw, k, s), out_ch
        specs.append(ParamSpec("fc/w", (hw * hw * ch, self.FC), "normc", 1.0))
        specs.append(ParamSpec("fc/bn_b", (self.FC,), "zeros"))
        specs += [
            ParamSpec("out/w", (self.FC, self.num_actions), "normc", self.OUT_STD),
            ParamSpec("out/b", (self.num_actions,), "zeros"),
        ]
        return specs

    # ------------------------------------------------------------------ params

    def prepare_parts(self, parts):
        """Cast the conv and fc weights (the bytes each step reads) to the
        compute dtype as contiguous copies, once per rollout; K1 reads fc/w
        as one contiguous ``[B, K, N]`` block. Biases and the out layer stay
        float32 views."""
        dt = self.dtype
        return {
            k: v.to(dt).contiguous() if k.endswith("/w") and not k.startswith("out") else v
            for k, v in parts.items()
        }

    @staticmethod
    def _normalize(parts, name, h, mean, inv_std):
        """x̂ = (h − μ)·inv_σ + b with μ, inv_σ, b ``[B, C]`` broadcast over
        any axes between the member axis and the channel axis."""
        shape = (h.shape[0],) + (1,) * (h.ndim - 2) + (h.shape[-1],)
        return (h - mean.reshape(shape)) * inv_std.reshape(shape) + parts[f"{name}/bn_b"].reshape(shape)

    # --------------------------------------------------------------- ref stats

    def _ref_stats_chunk(self, thetas: torch.Tensor, ref_batch: torch.Tensor) -> VBNStats:
        """Moments of C members' forwards of the reference batch ``[R, H, W,
        Cin]``: over (batch, h, w) for the convs, over batch for the fc."""
        dt = self.dtype
        parts = self.prepare_parts(self.unflatten(thetas))
        C, R = thetas.shape[0], ref_batch.shape[0]
        means, inv_stds = [], []
        x = ref_batch.to(dt)  # [R, H, W, Cin]: the same frames for every member
        for i, (name, _, k, s) in enumerate(self.LAYERS):
            w = parts[f"{name}/w"]  # [C, k, k, cin, cout]
            kk, cout = k * k * w.shape[3], w.shape[4]
            if i == 0:
                p = extract_patches(x, k, s)  # [R, h, w, kk], shared by the members
                hw = p.shape[1:3]
                h = torch.matmul(p.reshape(1, -1, kk).float(), w.reshape(C, kk, cout).float())
            else:
                p = extract_patches(x.reshape((C * R,) + tuple(x.shape[2:])), k, s)
                hw = p.shape[1:3]
                h = torch.bmm(p.reshape(C, -1, kk).float(), w.reshape(C, kk, cout).float())
            h = h.to(dt).float()  # the JAX ref pass rounds conv outputs to the compute dtype
            mean, inv = _moments(h, 1)
            means.append(mean)
            inv_stds.append(inv)
            x = torch.relu(self._normalize(parts, name, h, mean, inv)).to(dt)
            x = x.reshape((C, R) + tuple(hw) + (cout,))
        h = torch.bmm(x.reshape(C, R, -1).float(), parts["fc/w"].float()).to(dt).float()
        mean, inv = _moments(h, 1)
        means.append(mean)
        inv_stds.append(inv)
        return VBNStats(tuple(means), tuple(inv_stds))

    def batch_ref_stats(self, thetas: torch.Tensor, ref_batch: torch.Tensor) -> VBNStats:
        """Per-member stats for a population ``[B, D]``, ``REF_STATS_CHUNK``
        members at a time to bound peak memory."""
        chunk = self.REF_STATS_CHUNK
        parts = [self._ref_stats_chunk(thetas[s : s + chunk], ref_batch) for s in range(0, thetas.shape[0], chunk)]
        return VBNStats(
            tuple(torch.cat(xs) for xs in zip(*(p.mean for p in parts))),
            tuple(torch.cat(xs) for xs in zip(*(p.inv_std for p in parts))),
        )

    # ----------------------------------------------------------------- forward

    def batch_scores_parts(self, parts, obs: torch.Tensor, ctx: VBNStats) -> torch.Tensor:
        """``[B, H, W, C]`` frames → action scores ``[B, A]`` float32."""
        if ctx is None:
            raise ValueError("VirtualBNDQN needs the members' reference-batch stats")
        dt = self.dtype
        B = obs.shape[0]
        x = obs.to(dt)
        for i, (name, _, _, s) in enumerate(self.LAYERS):
            h = batch_conv2d(parts[f"{name}/w"], x, stride=s)
            x = torch.relu(self._normalize(parts, name, h, ctx.mean[i], ctx.inv_std[i])).to(dt)
        h = pop_matvec(x.reshape(B, -1), parts["fc/w"])
        i = len(self.LAYERS)
        x = torch.relu(self._normalize(parts, "fc", h, ctx.mean[i], ctx.inv_std[i]))
        return torch.einsum("bk,bkn->bn", x, parts["out/w"].float()) + parts["out/b"]

    def batch_act_parts(self, parts, obs, ctx):
        return torch.argmax(self.batch_scores_parts(parts, obs, ctx), dim=-1)
