"""DQN-family conv policies for Atari: the GA's and RS's models.

The counterpart of the JAX package's models/dqn.py, after the GPU stack's
``Model`` (small DQN 16-32-256) and ``LargeModel`` (32-64-64-512),
gpu neuroevolution/models/dqn.py:30-47, and their Xavier-scaled variants
(dqn_xavier.py:24-42). All SAME padding, NHWC, relu unless noted:

    conv1 k8 s4 → conv2 k4 s2 [→ conv3 k3 s1 (large)] → flatten → fc → out

on ``in_hw``×``in_hw``×``in_ch`` frames (84×84×4 by default). The fields
are the JAX package's (dqn.py:37-45): ``in_hw``, ``in_ch``, ``nonlin_type``
(any of ``NONLINS``, after every layer but the out layer) and ``out_std``
(the out layer's normc scale, the CPU stack's ``ac_init_std``); ``LAYERS``
and ``FC`` stay fixed per class, as there.

θ has the JAX package's flat layout (``build_specs`` order), so a θ moves
between the packages unchanged (weights.from_jax). The action is the argmax
of the scores.

Population forward routes:

* split (``batch_scores_parts``): the convs as batched products over im2col
  patches (``conv_impl='einsum'``, plain torch) or through kernel K5
  (``conv_impl='fused'``, ops/fused_dqn.py); the fc through ``pop_matvec``
  (kernel K1 on a CUDA tensor, whatever the nonlinearity); the out layer in
  f32. ``conv_impl='auto'`` stays on the batched products, as in the JAX
  package (dqn.py:128-133).
* LargeDQN whole-net (``forward_impl``): ``'fused'`` runs kernel K3 on the
  ``fuse_prepare`` layout, ``'split'`` the split route, and ``'auto'`` K3
  when θ lies on a CUDA device and the topology is the reference's, else the
  split route (the JAX package's "fused iff on TPU", dqn.py:208-216),
  for up to 64 actions.

K5 and K3 are written for the reference topology with relu on 84×84×4
frames (the JAX package's ``_conv_fused_eligible`` and
``_whole_fused_eligible``, dqn.py:107-115, 200-206): any other model takes
the split route on 'auto' (so a tanh LargeDQN runs K1 where the relu one
runs K3), and a forced ``'fused'`` raises ``ValueError`` when the model is
built.

``compute_dtype='bfloat16'`` casts the parameters to bf16 once per rollout
(``prepare_parts``); sums stay f32.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import fused_dqn as fk
from ..ops.flat import ParamSpec
from .core import NONLINS, Model, batch_conv2d, extract_patches, pop_matvec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _conv_out_hw(hw: int, k: int, s: int) -> int:
    return -(-hw // s)  # SAME padding


@dataclasses.dataclass(frozen=True)
class SmallDQN(Model):
    """conv16(8,4) → conv32(4,2) → fc256 → out (dqn.py:34-40)."""

    num_actions: int = 0
    scale_style: str = "fan_in"  # genome scaling: dqn.py:26-28
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    conv_impl: str = "auto"  # 'auto' | 'fused' (K5) | 'einsum'
    nonlin_type: str = "relu"  # a NONLINS name
    in_hw: int = 84  # input frames [in_hw, in_hw, in_ch]
    in_ch: int = 4
    out_std: float = 0.1  # dqn.py:40 out std; GAAtariPolicy's ac_init_std default (policies.py:436)

    LAYERS: ClassVar[Tuple[Tuple[str, int, int, int], ...]] = (("conv1", 16, 8, 4), ("conv2", 32, 4, 2))
    FC: ClassVar[int] = 256

    def __post_init__(self):
        if self.compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        if self.conv_impl not in ("auto", "fused", "einsum"):
            raise ValueError(f"conv_impl must be 'auto', 'fused' or 'einsum', not {self.conv_impl!r}")
        if self.nonlin_type not in NONLINS:
            raise ValueError(f"nonlin_type must be one of {sorted(NONLINS)}, not {self.nonlin_type!r}")
        if self.conv_impl == "fused" and not self._reference_input():
            raise ValueError("conv_impl='fused' (K5) needs relu on 84×84×4 frames, not "
                             f"{self.nonlin_type} on {self.in_hw}×{self.in_hw}×{self.in_ch}")
        super().__post_init__()

    def _reference_input(self) -> bool:
        """The fused kernels' reference: relu on 84×84×4 frames (dqn.py:107-115)."""
        return (self.in_hw, self.in_ch, self.nonlin_type) == (84, 4, "relu")

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def build_specs(self) -> Sequence[ParamSpec]:
        specs = []
        hw, ch = self.in_hw, self.in_ch
        for name, out_ch, k, s in self.LAYERS:
            specs += [
                ParamSpec(f"{name}/w", (k, k, ch, out_ch), "normc", 1.0),
                ParamSpec(f"{name}/b", (out_ch,), "zeros"),
            ]
            hw, ch = _conv_out_hw(hw, k, s), out_ch
        specs += [
            ParamSpec("fc/w", (hw * hw * ch, self.FC), "normc", 1.0),
            ParamSpec("fc/b", (self.FC,), "zeros"),
            ParamSpec("out/w", (self.FC, self.num_actions), "normc", self.out_std),
            ParamSpec("out/b", (self.num_actions,), "zeros"),
        ]
        return specs

    def prepare_parts(self, parts):
        """The compute-dtype cast, once per rollout, as fresh contiguous
        copies: the kernels read each member's weights as one contiguous,
        16-byte aligned block."""
        return {k: v.to(self.dtype, copy=True).contiguous() for k, v in parts.items()}

    # ----------------------------------------------------------------- convs

    def conv_chain_args(self, parts, obs: torch.Tensor) -> list:
        """K5's arguments: conv1's im2col of the frames (built outside the
        kernel), then each conv's ``[B, k·k·cin, cout]`` weight and
        ``[B, 1, cout]`` f32 bias."""
        B = obs.shape[0]
        args = [extract_patches(obs.to(self.dtype), 8, 4).reshape(B, fk.P1, -1)]
        for name, _, _, _ in self.LAYERS:
            w = parts[f"{name}/w"]
            args += [w.reshape(B, -1, w.shape[-1]), parts[f"{name}/b"][:, None, :].float().contiguous()]
        return args

    def conv_acts(self, parts, obs: torch.Tensor) -> torch.Tensor:
        """The conv stack's flattened activations ``[B, h·w·c_out]`` in the
        compute dtype: K5 with ``conv_impl='fused'``, else batched products
        over im2col patches."""
        dt = self.dtype
        B = obs.shape[0]
        # 'auto' stays on the batched products, as in the JAX package
        if self.conv_impl == "fused":
            return fk.dqn_conv_chain_fused(*self.conv_chain_args(parts, obs)).to(dt).reshape(B, -1)
        nonlin = NONLINS[self.nonlin_type]
        x = obs.to(dt)
        for name, _, _, s in self.LAYERS:
            y = batch_conv2d(parts[f"{name}/w"], x, stride=s) + parts[f"{name}/b"].float()[:, None, None, :]
            x = nonlin(y).to(dt)
        return x.reshape(B, -1)

    # --------------------------------------------------------------- forward

    def batch_scores_parts(self, parts, obs: torch.Tensor, ctx=None) -> torch.Tensor:
        """``[B, in_hw, in_hw, in_ch]`` frames → action scores ``[B, A]`` f32:
        the convs, the fc through ``pop_matvec`` (K1), the out layer in f32."""
        h = pop_matvec(self.conv_acts(parts, obs), parts["fc/w"]) + parts["fc/b"].float()
        x = NONLINS[self.nonlin_type](h)
        return torch.einsum("bk,bkn->bn", x, parts["out/w"].float()) + parts["out/b"].float()

    def batch_act_parts(self, parts, obs, ctx=None):
        return torch.argmax(self.batch_scores_parts(parts, obs, ctx), dim=-1)


@dataclasses.dataclass(frozen=True)
class LargeDQN(SmallDQN):
    """conv32(8,4) → conv64(4,2) → conv64(3,1) → fc512 → out (dqn.py:43-47).

    ``forward_impl='auto'`` runs kernel K3, the whole net per member, when θ
    lies on a CUDA device (see the module docstring)."""

    forward_impl: str = "auto"  # 'auto' | 'fused' (K3) | 'split'

    LAYERS: ClassVar[Tuple[Tuple[str, int, int, int], ...]] = (
        ("conv1", 32, 8, 4),
        ("conv2", 64, 4, 2),
        ("conv3", 64, 3, 1),
    )
    FC: ClassVar[int] = 512

    def __post_init__(self):
        if self.forward_impl not in ("auto", "fused", "split"):
            raise ValueError(f"forward_impl must be 'auto', 'fused' or 'split', not {self.forward_impl!r}")
        super().__post_init__()
        if self.forward_impl == "fused" and not self._reference_input():
            raise ValueError("forward_impl='fused' (K3) needs relu on 84×84×4 frames, not "
                             f"{self.nonlin_type} on {self.in_hw}×{self.in_hw}×{self.in_ch}")

    def _whole_fused_eligible(self) -> bool:
        """K3's reference topology with relu, and up to 64 actions (its
        padded action lanes; dqn.py:200-206)."""
        return self._reference_input() and 0 < self.num_actions <= fk.NOUT

    def _use_whole_fused(self, device: torch.device) -> bool:
        if self.forward_impl == "fused":
            if not 0 < self.num_actions <= fk.NOUT:
                raise ValueError(f"forward_impl='fused' takes at most {fk.NOUT} actions, not {self.num_actions}")
            return True
        return self.forward_impl == "auto" and self._whole_fused_eligible() and device.type == "cuda"

    def fuse_prepare(self, parts) -> Dict[str, torch.Tensor]:
        """K3's weight layout (dqn.py:218-248) from compute-dtype parts
        ``[B, ...]``: bf16 weight matrices in (i, j, c) row order; the fc
        rows channel-major, ``wf[b, c, p, :] = fc/w[b, p·64 + c, :]`` (the
        NHWC flatten index is p·64 + c); f32 biases; the out layer f32 with
        its lanes padded to 64 by zero weights and a −1e9 bias."""
        B = parts["conv1/w"].shape[0]
        bf, f32 = torch.bfloat16, torch.float32
        dev = parts["conv1/w"].device
        wf = torch.empty((B, fk.LG_C3, fk.P2, fk.LG_FC), dtype=bf, device=dev)
        wf.copy_(parts["fc/w"].reshape(B, fk.P2, fk.LG_C3, fk.LG_FC).transpose(1, 2))
        pad = fk.NOUT - self.num_actions
        return {
            "w1": parts["conv1/w"].reshape(B, fk.KK1, fk.LG_C1).to(bf).contiguous(),
            "b1": parts["conv1/b"][:, None, :].to(f32).contiguous(),
            "w2": parts["conv2/w"].reshape(B, 16 * fk.LG_C1, fk.LG_C2).to(bf).contiguous(),
            "b2": parts["conv2/b"][:, None, :].to(f32).contiguous(),
            "w3": parts["conv3/w"].reshape(B, 9 * fk.LG_C2, fk.LG_C3).to(bf).contiguous(),
            "b3": parts["conv3/b"][:, None, :].to(f32).contiguous(),
            "wf": wf,
            "bf": parts["fc/b"][:, None, :].to(f32).contiguous(),
            "wo": F.pad(parts["out/w"].to(f32), (0, pad)),
            "bo": F.pad(parts["out/b"].to(f32), (0, pad), value=-1e9)[:, None, :],
        }

    def prepare_batch_params(self, params):
        """``(thetas [B, D], ctx)`` → prepared ``(parts, ctx)``, once per
        rollout: the K3 layout under ``"__fused_lg__"`` on the whole-net
        route, else the split route's parts."""
        thetas, ctx = params
        if isinstance(thetas, dict):
            return params
        if self._use_whole_fused(thetas.device):
            # the compute-dtype cast without prepare_parts' contiguous copies:
            # fuse_prepare copies every tensor once into its own layout
            parts = {k: v.to(self.dtype) for k, v in self.unflatten(thetas).items()}
            return {"__fused_lg__": self.fuse_prepare(parts)}, ctx
        return self.prepare_parts(self.unflatten(thetas)), ctx

    def batch_scores_fused(self, fused_ops: Dict[str, torch.Tensor], obs: torch.Tensor) -> torch.Tensor:
        """Padded scores ``[B, 64]`` from K3; conv1's im2col (bf16) runs
        outside the kernel."""
        B = obs.shape[0]
        patches1 = extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, fk.P1, fk.KK1)
        return fk.large_dqn_fused_scores(dict(fused_ops, patches1=patches1))

    def batch_act_parts(self, parts, obs, ctx=None):
        if "__fused_lg__" in parts:
            return torch.argmax(self.batch_scores_fused(parts["__fused_lg__"], obs), dim=-1)
        return super().batch_act_parts(parts, obs, ctx)


@dataclasses.dataclass(frozen=True)
class SmallDQNXavier(SmallDQN):
    """dqn_xavier.py:31-33 SmallDQN: the same net, base.py:46-49 genome scaling."""

    scale_style: str = "base"


@dataclasses.dataclass(frozen=True)
class LargeDQNXavier(LargeDQN):
    scale_style: str = "base"


# reference-name aliases (the GPU stack resolves models by class name,
# gpu_implementation/es.py:144)
ModelSmall = SmallDQN
ModelLarge = LargeDQN
