"""MujocoPolicy: the feed-forward MLP for continuous control.

The counterpart of the JAX package's models/mlp.py (es_distributed/
policies.py:122-302):

* observations normalized as clip((o − μ)/σ, ±5) by running stats that ride
  in the context (policies.py:149-152);
* hidden layers nonlin(dense(h)), normc(1.0) (policies.py:155-161);
* action heads (policies.py:166-198): 'continuous' (dense, normc 0.01),
  'uniform:k' (k bins a dimension, argmax, spread over low..high) and
  'custom:v,...' (bins at the given values in [-1, 1], rescaled to
  [low, high]);
* action noise a += N(0, 1)·ac_noise_std·noise_scale (policies.py:202-206),
  drawn from the context's generator; ``noise_scale`` 1 in training
  rollouts, 0 in eval ones. With ``paired`` the two halves of the batch
  (θ+σε and θ−σε) take the same draws, as the JAX package's antithetic
  pairs share their episode keys.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.flat import ParamSpec
from .core import NONLINS, Model, dense


class MLPContext(NamedTuple):
    ob_mean: torch.Tensor  # [obs_dim]
    ob_std: torch.Tensor  # [obs_dim]
    noise_scale: float  # 1.0 applies ac_noise_std, 0.0 turns it off
    gen: Optional[torch.Generator] = None  # the action noise's stream
    paired: bool = False  # the batch's halves share their draws


@dataclasses.dataclass(frozen=True)
class MujocoMLP(Model):
    obs_dim: int = 0
    ac_dim: int = 0
    ac_low: Tuple[float, ...] = ()
    ac_high: Tuple[float, ...] = ()
    ac_bins: str = "continuous:"  # mode[:arg] (policies.py:171)
    ac_noise_std: float = 0.01
    nonlin_type: str = "tanh"
    hidden_dims: Tuple[int, ...] = (256, 256)
    connection_type: str = "ff"

    def __post_init__(self):
        if self.connection_type != "ff":
            raise NotImplementedError("the reference implements only 'ff' (policies.py:155-162)")
        super().__post_init__()
        mode, _, arg = self.ac_bins.partition(":")
        if mode == "custom":
            vals = tuple(float(v) for v in arg.split(","))
            if vals[0] != -1 or vals[-1] != 1:  # policies.py:183
                raise ValueError(f"custom bins must run from -1 to 1, got {vals}")
            object.__setattr__(self, "_acvals", vals)
        elif mode not in ("uniform", "continuous"):
            raise NotImplementedError(mode)
        object.__setattr__(self, "_bin_mode", mode)
        object.__setattr__(self, "_consts", {})

    @property
    def needs_ob_stat(self) -> bool:
        return True  # policies.py:211-213

    @property
    def num_bins(self) -> int:
        mode, _, arg = self.ac_bins.partition(":")
        if mode == "uniform":
            return int(arg)
        return len(arg.split(",")) if mode == "custom" else 0

    def build_specs(self) -> Sequence[ParamSpec]:
        specs, in_dim = [], self.obs_dim
        for i, hd in enumerate(self.hidden_dims):
            specs += [ParamSpec(f"l{i}/w", (in_dim, hd), "normc", 1.0), ParamSpec(f"l{i}/b", (hd,), "zeros")]
            in_dim = hd
        out = self.ac_dim * max(self.num_bins, 1)
        return specs + [
            ParamSpec("out/w", (in_dim, out), "normc", 0.01),  # policies.py:117,196
            ParamSpec("out/b", (out,), "zeros"),
        ]

    def _action_consts(self, device: torch.device):
        """(low [ac_dim], high [ac_dim], each dimension's custom bin values
        [ac_dim, k] rescaled to [low, high] (policies.py:185-188), or None),
        float32 on ``device``, made once per device: a step captured in a
        CUDA graph may not copy from the host."""
        if device not in self._consts:
            low = torch.tensor(self.ac_low, dtype=torch.float32, device=device)
            high = torch.tensor(self.ac_high, dtype=torch.float32, device=device)
            ak = None
            if self._bin_mode == "custom":
                vals = torch.tensor(self._acvals, dtype=torch.float32, device=device)
                ak = (high - low)[:, None] / (vals[-1] - vals[0]) * (vals - vals[0])[None, :] + low[:, None]
            self._consts[device] = (low, high, ak)
        return self._consts[device]

    def batch_act_parts(self, parts, obs, ctx: Optional[MLPContext] = None) -> torch.Tensor:
        nonlin = NONLINS[self.nonlin_type]
        x = obs.to(torch.float32)
        if ctx is not None:
            x = torch.clamp((x - ctx.ob_mean) / ctx.ob_std, -5.0, 5.0)  # policies.py:151
        for i in range(len(self.hidden_dims)):
            x = nonlin(dense(parts, f"l{i}", x))
        scores = dense(parts, "out", x)
        if self._bin_mode == "continuous":
            a = scores
        else:
            low, high, ak = self._action_consts(x.device)
            k = self.num_bins
            aidx = torch.argmax(scores.reshape(-1, self.ac_dim, k), dim=-1)  # [B, ac_dim] (policies.py:176)
            if self._bin_mode == "uniform":
                a = aidx.to(torch.float32) / (k - 1.0) * (high - low) + low  # policies.py:178
            else:
                a = torch.gather(ak.expand(aidx.shape[0], -1, -1), 2, aidx[..., None])[..., 0]
        if ctx is not None and ctx.gen is not None and self.ac_noise_std != 0 and ctx.noise_scale != 0:
            n = a.shape[0] // 2 if ctx.paired else a.shape[0]
            z = torch.randn((n,) + tuple(a.shape[1:]), generator=ctx.gen, device=ctx.gen.device).to(a.device)
            z = torch.cat([z, z]) if ctx.paired else z
            a = a + z * (self.ac_noise_std * ctx.noise_scale)
        return a


def default_context(obs_dim: int, device=None) -> MLPContext:
    """Identity normalization, no action noise."""
    return MLPContext(
        torch.zeros(obs_dim, dtype=torch.float32, device=device),
        torch.ones(obs_dim, dtype=torch.float32, device=device),
        0.0,
    )
