"""Virtual-batch-norm small DQN (ModelVirtualBN), the ES path's policy, and
its live batch-norm variant (ModelBN).

The counterpart of the JAX package's models/batchnorm.py ``VirtualBNDQN``
(the GPU stack's ModelVirtualBN, gpu neuroevolution/models/batchnorm.py:
52-123): bias-free conv16(8,4) → conv32(4,2) → fc256 → out, and after each
of the first three layers a per-member normalization x̂ = (x − μ)·inv_σ,
where μ and inv_σ = 1/√(var + 1e-3) are the moments of the member's own
forward of the reference batch over batch and spatial axes, followed by
the affine: ``affine='bias'`` (the GPU stack) adds a learned bias b,
``affine='full'`` (the CPU stack's γ/β) computes x̂·(1 + g) + b, with the
learned g stored as γ − 1 so that a zero init is the identity.

Population forward routes (``forward_impl``):

* ``'split'`` (``batch_scores_parts``): the convs as batched products over
  im2col patches, the fc through ``pop_matvec`` (kernel K1 on a CUDA
  tensor), the normalization as separate elementwise passes;
* ``'folded'`` (``fold_batch_parts`` + ``batch_scores_folded``): the split
  route with each normalization folded into the layer's weights and a
  bias, once per rollout (plain torch, the fc on K1);
* ``'fused1'``: kernel K4 (``ops.fused_dqn.vbn_dqn_fused1_scores``), the
  whole net per member, on ``fuse_prepare(style='one')``'s layout;
* ``'fused'``: kernel K6 (``ops.fused_dqn.vbn_dqn_fused_scores``), the same
  net with x2 rounded to bf16 before the fc, on ``style='two'``'s layout;
* ``'auto'``: ``'split'``, on the card too, as in the JAX package
  (batchnorm.py:291-302).

``compute_dtype="bfloat16"`` runs the split and folded routes' products on
bfloat16 weights and activations with float32 sums; θ, the moments and the
normalization stay float32. Where the JAX package rounds a product's
output to the compute dtype (the reference-batch pass), the port rounds it
too. The fused routes take bfloat16 weights whatever ``compute_dtype``
says, as in the JAX package.

The fields are the JAX package's (batchnorm.py:47-52): ``in_hw``,
``in_ch``, ``nonlin_type`` (any of ``NONLINS``, after each normalization)
and ``out_std`` (the out layer's normc scale); ``LAYERS`` and ``FC`` stay
fixed per class, as there. K4 and K6 are written for relu on 84×84×4
frames: a forced fused route on any other model raises ``ValueError`` when
the model is built, and 'auto' never takes them. (The JAX package's
``_fused_eligible``, batchnorm.py:283-289, does not look at the
nonlinearity: its fused kernels apply relu whatever ``nonlin_type`` says.)

``BNDQN`` (ModelBN, the JAX package's batchnorm.py:425-461) normalizes by
live moments instead: each member's batch is its one env slot, so a conv's
moments are taken over the spatial axes, and the fc's, at a batch of one,
over its features (the layer is centred by itself). No reference batch,
no fused route; its products are plain batched products in float32 (the
JAX package vmaps them, with no Pallas kernel), the weights rounded to the
compute dtype first.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import fused_dqn as fk
from ..ops.flat import ParamSpec
from ..utils.trace import span
from .core import NONLINS, Model, argmax_actions, batch_conv2d, extract_patches, pop_matvec

VBN_EPS = 1e-3  # batchnorm.py:76; policies.py:322 epsilon=1e-3
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FORWARD_IMPLS = ("auto", "split", "folded", "fused", "fused1")


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
    affine: str = "bias"  # 'bias' (GPU ModelVirtualBN) | 'full' (CPU ESAtariPolicy γ/β)
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    forward_impl: str = "auto"  # see the module docstring
    nonlin_type: str = "relu"  # a NONLINS name
    in_hw: int = 84  # input frames [in_hw, in_hw, in_ch]
    in_ch: int = 4
    out_std: float = 1.0  # batchnorm.py:110 dense('out') default std

    LAYERS: ClassVar[Tuple[Tuple[str, int, int, int], ...]] = (("conv1", 16, 8, 4), ("conv2", 32, 4, 2))
    FC: ClassVar[int] = 256
    # members whose reference-batch forwards are live at once in
    # batch_ref_stats: conv2's patches alone are R·121·256 floats per member
    REF_STATS_CHUNK: ClassVar[int] = 32

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        if self.affine not in ("bias", "full"):
            raise ValueError(f"affine must be 'bias' or 'full', not {self.affine!r}")
        if self.forward_impl not in _FORWARD_IMPLS:
            raise ValueError(f"forward_impl must be one of {_FORWARD_IMPLS}, not {self.forward_impl!r}")
        if self.nonlin_type not in NONLINS:
            raise ValueError(f"nonlin_type must be one of {sorted(NONLINS)}, not {self.nonlin_type!r}")
        if self._use_fused() and not 0 < self.num_actions <= fk.NOUT:
            raise ValueError(f"forward_impl={self.forward_impl!r} takes 1 to {fk.NOUT} actions, not {self.num_actions}")
        super().__post_init__()

    @property
    def needs_ref_batch(self) -> bool:
        return True

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def build_specs(self) -> Sequence[ParamSpec]:
        specs = []
        hw, ch = self.in_hw, self.in_ch
        for name, out_ch, k, s in self.LAYERS:
            specs.append(ParamSpec(f"{name}/w", (k, k, ch, out_ch), "normc", 1.0))
            specs.append(ParamSpec(f"{name}/bn_b", (out_ch,), "zeros"))
            if self.affine == "full":
                specs.append(ParamSpec(f"{name}/bn_g", (out_ch,), "zeros"))  # γ − 1
            hw, ch = _conv_out_hw(hw, k, s), out_ch
        specs.append(ParamSpec("fc/w", (hw * hw * ch, self.FC), "normc", 1.0))
        specs.append(ParamSpec("fc/bn_b", (self.FC,), "zeros"))
        if self.affine == "full":
            specs.append(ParamSpec("fc/bn_g", (self.FC,), "zeros"))
        specs += [
            ParamSpec("out/w", (self.FC, self.num_actions), "normc", self.out_std),
            ParamSpec("out/b", (self.num_actions,), "zeros"),
        ]
        return specs

    # ------------------------------------------------------------------ params

    def prepare_parts(self, parts):
        """Cast the conv and fc weights (the bytes each step reads) to the
        compute dtype as contiguous copies, once per rollout; K1 reads fc/w
        as one contiguous ``[B, K, N]`` block. Biases, gains and the out
        layer stay float32 views."""
        dt = self.dtype
        return {
            k: v.to(dt).contiguous() if k.endswith("/w") and not k.startswith("out") else v
            for k, v in parts.items()
        }

    def _normalize(self, parts, name, h, mean, inv_std):
        """x̂ = (h − μ)·inv_σ, then + b ('bias') or ·(1 + g) + b ('full'),
        with μ, inv_σ, g, b ``[B, C]`` broadcast over any axes between the
        member axis and the channel axis."""
        shape = (h.shape[0],) + (1,) * (h.ndim - 2) + (h.shape[-1],)
        x = (h - mean.reshape(shape)) * inv_std.reshape(shape)
        if self.affine == "full":
            x = x * (1.0 + parts[f"{name}/bn_g"].reshape(shape))
        return x + parts[f"{name}/bn_b"].reshape(shape)

    # --------------------------------------------------------------- ref stats

    def _ref_stats_chunk(self, thetas: torch.Tensor, ref_batch: torch.Tensor) -> VBNStats:
        """Moments of C members' forwards of the reference batch ``[R, H, W,
        Cin]``: over (batch, h, w) for the convs, over batch for the fc."""
        dt = self.dtype
        nonlin = NONLINS[self.nonlin_type]
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
            x = nonlin(self._normalize(parts, name, h, mean, inv)).to(dt)
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
        nonlin = NONLINS[self.nonlin_type]
        B = obs.shape[0]
        with span("model.convs"):
            x = obs.to(dt)
            for i, (name, _, _, s) in enumerate(self.LAYERS):
                h = batch_conv2d(parts[f"{name}/w"], x, stride=s)
                x = nonlin(self._normalize(parts, name, h, ctx.mean[i], ctx.inv_std[i])).to(dt)
        with span("model.fc"):
            h = pop_matvec(x.reshape(B, -1), parts["fc/w"])
            i = len(self.LAYERS)
            x = nonlin(self._normalize(parts, "fc", h, ctx.mean[i], ctx.inv_std[i]))
        with span("model.out"):
            return torch.einsum("bk,bkn->bn", x, parts["out/w"].float()) + parts["out/b"]

    # ------------------------------------------------------------- routes

    def _use_folded(self) -> bool:
        return self.forward_impl == "folded"

    def _fused_eligible(self) -> bool:
        """K4 and K6 are written for the reference topology, 84×84×4 →
        conv16/8s4 → conv32/4s2 → fc256 (batchnorm.py:283-289), with relu."""
        return (
            (self.in_hw, self.in_ch, self.FC, self.nonlin_type) == (84, 4, fk.FC, "relu")
            and self.LAYERS == (("conv1", fk.C1, 8, 4), ("conv2", fk.C2, 4, 2))
        )

    def _use_fused(self):
        """The fused route, ``'fused'`` (K6) or ``'fused1'`` (K4), or False.
        ``'auto'`` stays on the split route (batchnorm.py:291-302)."""
        if self.forward_impl in ("fused", "fused1"):
            if not self._fused_eligible():
                raise ValueError(f"forward_impl={self.forward_impl!r}: the fused VBN-DQN kernels need relu on "
                                 f"84×84×4 frames, not {self.nonlin_type} on {self.in_hw}×{self.in_hw}×{self.in_ch}")
            return self.forward_impl
        return False

    def _fold(self, parts, stats: VBNStats, name: str, i: int):
        """The normalization of layer ``i`` as a per-channel scale and shift
        ``[B, C]``: a = inv_σ·(1 + g), c = b − μ·a, so that x̂ = h·a + c."""
        a = stats.inv_std[i]
        if self.affine == "full":
            a = a * (1.0 + parts[f"{name}/bn_g"])
        return a, parts[f"{name}/bn_b"] - stats.mean[i] * a

    def fold_batch_parts(self, parts, stats: VBNStats) -> dict:
        """The 'folded' route's weights (batchnorm.py:222-251) from parts
        ``[B, ...]``: conv(x, W)·a + c = conv(x, W·a) + c, so each layer's
        scale goes into its weight columns (a product in the compute dtype)
        and its shift into a bias."""
        dt = self.dtype
        folded = {}
        for i, (name, _, _, _) in enumerate(self.LAYERS):
            a, c = self._fold(parts, stats, name, i)
            folded[f"{name}/w"] = parts[f"{name}/w"].to(dt) * a[:, None, None, None, :].to(dt)
            folded[f"{name}/b"] = c
        a3, c3 = self._fold(parts, stats, "fc", len(self.LAYERS))
        folded["fc/w"] = parts["fc/w"].to(dt) * a3[:, None, :].to(dt)
        folded["fc/b"] = c3
        folded["out/w"], folded["out/b"] = parts["out/w"], parts["out/b"]
        return folded

    def batch_scores_folded(self, fparts, obs: torch.Tensor) -> torch.Tensor:
        """Scores ``[B, A]`` over folded weights: the split route's products
        with a bias and the nonlinearity after each (batchnorm.py:253-268)."""
        dt = self.dtype
        nonlin = NONLINS[self.nonlin_type]
        B = obs.shape[0]
        with span("model.convs"):
            x = obs.to(dt)
            for name, _, _, s in self.LAYERS:
                h = batch_conv2d(fparts[f"{name}/w"], x, stride=s)
                x = nonlin(h + fparts[f"{name}/b"][:, None, None, :]).to(dt)
        with span("model.fc"):
            x = nonlin(pop_matvec(x.reshape(B, -1), fparts["fc/w"]) + fparts["fc/b"])
        with span("model.out"):
            return torch.einsum("bk,bkn->bn", x, fparts["out/w"].float()) + fparts["out/b"]

    def fuse_prepare(self, parts, stats: VBNStats, style: str = "two") -> Dict[str, torch.Tensor]:
        """K4's (``style='one'``) or K6's (``'two'``) layout from parts
        ``[B, ...]`` (batchnorm.py:304-349): the conv weights as bf16
        ``[B, k·k·cin, cout]`` in (i, j, c) rows; each normalization folded
        into f32 ``a``, ``c`` ``[B, 1, C]``; the out layer f32 with its lanes
        padded to 64 by zero weights and a −1e9 bias. The fc weights are
        bf16, channel-major ``wf_cm[b, c, p, :] = fc/w[b, p·32 + c, :]``
        (style 'one') or row-major ``wf`` ``[B, 3872, 256]`` (style 'two')."""
        if style not in ("one", "two"):
            raise ValueError(f"style must be 'one' or 'two', not {style!r}")
        B = parts["conv1/w"].shape[0]
        bf, f32 = torch.bfloat16, torch.float32
        ops = {}
        for i, (name, c_out, _, _) in enumerate(self.LAYERS + (("fc", self.FC, 0, 0),)):
            a, c = self._fold(parts, stats, name, i)
            ops[f"a{i + 1}"] = a[:, None, :].to(f32).contiguous()
            ops[f"c{i + 1}"] = c[:, None, :].to(f32).contiguous()
            if name != "fc":
                ops[f"w{i + 1}"] = parts[f"{name}/w"].reshape(B, -1, c_out).to(bf).contiguous()
        if style == "one":
            wf = torch.empty((B, fk.C2, fk.P2, fk.FC), dtype=bf, device=parts["fc/w"].device)
            wf.copy_(parts["fc/w"].reshape(B, fk.P2, fk.C2, fk.FC).transpose(1, 2))
            ops["wf_cm"] = wf
        else:
            ops["wf"] = parts["fc/w"].to(bf).contiguous()
        pad = fk.NOUT - self.num_actions
        ops["wo"] = F.pad(parts["out/w"].to(f32), (0, pad))
        ops["bo"] = F.pad(parts["out/b"].to(f32), (0, pad), value=-1e9)[:, None, :]
        return ops

    def batch_scores_fused(self, fused_ops: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
        """Padded scores ``[B, 64]`` from K4 (a ``wf_cm`` entry) or K6; conv1's
        im2col (bf16) runs outside the kernel (batchnorm.py:351-364)."""
        B = obs.shape[0]
        with span("model.convs"):
            patches1 = extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, fk.P1, fk.KK1)
        ops = dict(fused_ops, patches1=patches1)
        with span("model.fused"):
            if "wf_cm" in fused_ops:
                return fk.vbn_dqn_fused1_scores(ops)
            return fk.vbn_dqn_fused_scores(ops)

    def prepare_batch_params(self, params):
        """``(thetas [B, D], stats)`` → prepared ``(parts, stats)``, once per
        rollout slot group (batchnorm.py:377-394): the split route's parts,
        or the folded weights under ``"__folded__"``, or the K4/K6 layout
        under ``"__fused__"``. Prepared params pass through unchanged."""
        thetas, ctx = params
        if isinstance(thetas, dict):
            return params
        fused = self._use_fused()
        if not (fused or self._use_folded()):
            return self.prepare_parts(self.unflatten(thetas)), ctx
        if ctx is None:
            raise ValueError("VirtualBNDQN needs the members' reference-batch stats")
        # both layouts below are fresh tensors, cast as they are built: no
        # prepare_parts copies of θ
        parts = self.unflatten(thetas)
        if fused:
            return {"__fused__": self.fuse_prepare(parts, ctx, "one" if fused == "fused1" else "two")}, ctx
        return {"__folded__": self.fold_batch_parts(parts, ctx)}, ctx

    def batch_act_parts(self, parts, obs, ctx):
        if "__fused__" in parts:
            return argmax_actions(self.batch_scores_fused(parts["__fused__"], obs))
        if "__folded__" in parts:
            return argmax_actions(self.batch_scores_folded(parts["__folded__"], obs))
        return argmax_actions(self.batch_scores_parts(parts, obs, ctx))


@dataclasses.dataclass(frozen=True)
class BNDQN(VirtualBNDQN):
    """Live batch norm (ModelBN, batchnorm.py:24-49; the JAX package's
    batchnorm.py:425-461): see the module docstring. ``forward_impl`` takes
    'auto' or 'split', the one route."""

    def __post_init__(self):
        if self.forward_impl not in ("auto", "split"):
            raise ValueError(f"BNDQN has one route, the split one; forward_impl={self.forward_impl!r}")
        super().__post_init__()

    @property
    def needs_ref_batch(self) -> bool:
        return False

    def batch_scores_parts(self, parts, obs: torch.Tensor, ctx=None) -> torch.Tensor:
        """``[B, H, W, C]`` frames → action scores ``[B, A]`` float32, each
        member normalized by its own moments."""
        nonlin = NONLINS[self.nonlin_type]
        B = obs.shape[0]
        with span("model.convs"):
            x = obs.float()
            for name, _, _, s in self.LAYERS:
                h = batch_conv2d(parts[f"{name}/w"], x, stride=s)
                mean, inv = _moments(h, (1, 2))
                x = nonlin(self._normalize(parts, name, h, mean, inv))
        with span("model.fc"):
            h = torch.bmm(x.reshape(B, 1, -1), parts["fc/w"].float())[:, 0]
            mean, inv = _moments(h, 1)  # a batch of one: the layer centred by itself
            x = nonlin(self._normalize(parts, "fc", h, mean[:, None].expand_as(h), inv[:, None].expand_as(h)))
        with span("model.out"):
            return torch.bmm(x[:, None, :], parts["out/w"].float())[:, 0] + parts["out/b"]
