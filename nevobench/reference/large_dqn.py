"""Plain reference of the GA policy, LargeModel: the Nature DQN (Mnih et al.
2015) as uber-research/deep-neuroevolution's
gpu_implementation/neuroevolution/models/dqn.py LargeModel runs it in Such
et al. 2017 (arXiv:1712.06567).

84×84×4 frames → conv32 8×8/4 → conv64 4×4/2 → conv64 3×3/1 → fc512 →
actions, each layer with a bias, relu after all but the out layer.

The GA's route on the card computes its convs and fc on bfloat16 operands
with float32 sums (the JAX package's fused kernel, dqn.py:28-32): the frame
stack, every conv and fc weight, and the inputs of conv2 and conv3 are
rounded to bfloat16; the fc's input, the biases and the out layer stay
float32. ``scores`` rounds at exactly those points, to ``low``
('bfloat16', or a lower precision for the control), and computes
everything else in float32.
"""

from __future__ import annotations

from typing import List

import torch

from .common import Spec, nhwc_flatten, pop_conv, pop_linear, round_to, unflatten

CONVS = ("conv1", "conv2", "conv3")


def layout(cfg: dict) -> List[Spec]:
    """The flat θ layout of the published model: each layer's weight, then
    its bias."""
    specs, cin, hw = [], cfg["in_ch"], cfg["in_hw"]
    for name in CONVS:
        k, c = cfg[f"{name}_kernel"], cfg[f"{name}_channels"]
        specs += [(f"{name}/w", (k, k, cin, c), "normc", 1.0), (f"{name}/b", (c,), "zeros", 0.0)]
        cin, hw = c, cfg[f"{name}_out_hw"]
    fc, a = cfg["fc_units"], cfg["num_actions"]
    return specs + [
        ("fc/w", (hw * hw * cin, fc), "normc", 1.0), ("fc/b", (fc,), "zeros", 0.0),
        ("out/w", (fc, a), "normc", cfg["out_std"]), ("out/b", (a,), "zeros", 0.0),
    ]


def _bias(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """+ a ``[B, C]`` bias over ``[N, B, C, H, W]``."""
    return x + b[None, :, :, None, None]


def scorer(thetas: torch.Tensor, cfg: dict, low: str = "bfloat16"):
    """The scores of members ``thetas`` ``[B, D]``: a function of stacks
    ``[P, B, 4, 84, 84]`` → ``[P, B, A]``."""
    w = unflatten(thetas, layout(cfg))
    wl = {k: round_to(v.contiguous(), low) for k, v in w.items() if k.endswith("/w") and k != "out/w"}

    def scores(x: torch.Tensor) -> torch.Tensor:
        for name in CONVS:
            x = torch.relu(_bias(pop_conv(round_to(x, low), wl[f"{name}/w"], cfg[f"{name}_stride"]), w[f"{name}/b"]))
        h = torch.relu(pop_linear(nhwc_flatten(x), wl["fc/w"]) + w["fc/b"][None])
        return pop_linear(h, w["out/w"]) + w["out/b"][None]

    return scores
