"""LargeModel, the GA's Atari policy (configs/large_dqn_ga.json), on the
program's 'auto' route: on a CUDA θ, K3, the whole net a member, with
bfloat16 operands at the JAX fused kernel's rounding points.

What the benchmark makes for it from the seed: the genomes θ; the program
builds K3's bfloat16 layout from them at set-up (``act_fn.prepare``), and
the reference rounds the same weights itself.
"""

from __future__ import annotations

import torch

from nevobench import inputs
from nevobench.reference import large_dqn

K3_PAD = 64  # K3's padded action lanes: its out layer is read as [B, fc, 64] f32


def make_inputs(cfg: dict, traffic: dict, n: int, gen: torch.Generator, device) -> dict:
    """θ of ``n`` members and what else the configuration's forward takes."""
    return {"thetas": inputs.members(gen, large_dqn.layout(cfg), n, cfg["members"], device)}


def program(cfg: dict):
    from deep_neuroevolution_torch.models import get_model

    return get_model(cfg["model"])(**cfg["model_kwargs"])


def program_params(model, inp: dict):
    return inp["thetas"], None


def reference(cfg: dict, inp: dict, precision: str = "bfloat16"):
    """The reference's scores of the members: a function of stacks ``[P,
    B, 4, 84, 84]``, rounding where K3 rounds to bfloat16 to ``precision``
    (the control's 'float8_e4m3')."""
    return large_dqn.scorer(inp["thetas"], cfg, precision)


def products(cfg: dict):
    """(rows, depth, columns) of each product of one member's forward of
    one frame stack: the three convs as im2col products, the fc, the out
    layer."""
    out, cin = [], cfg["in_ch"]
    for name in ("conv1", "conv2", "conv3"):
        hw, c = cfg[f"{name}_out_hw"], cfg[f"{name}_channels"]
        out.append((hw * hw, cfg[f"{name}_kernel"] ** 2 * cin, c))
        cin = c
    hw = cfg["conv3_out_hw"]
    return out + [(1, hw * hw * cin, cfg["fc_units"]), (1, cfg["fc_units"], cfg["num_actions"])]


def forward_flops(cfg: dict) -> int:
    """FLOPs (2 a multiply-add) of one member's forward of one frame stack;
    biases and relus, under 0.2% of it, are not counted."""
    return 2 * sum(m * k * n for m, k, n in products(cfg))


def kernels(cfg: dict, group: int) -> dict:
    """K3 on one group (``group`` members): its inputs as passed (conv1's
    bfloat16 patches, the bfloat16 conv and fc weights, the float32 biases,
    the out layer padded to 64 lanes) each read once, the padded scores
    written once. Its FLOPs are the forward's, at bfloat16 on the tensor
    cores."""
    (p1, k1, c1), (_, k2, c2), (_, k3, c3), (_, kf, nf), _ = products(cfg)
    bf16, f32 = 2, 4
    per_member = (
        bf16 * (p1 * k1 + k1 * c1 + k2 * c2 + k3 * c3 + kf * nf)
        + f32 * (c1 + c2 + c3 + nf + nf * K3_PAD + K3_PAD)
        + f32 * K3_PAD
    )
    return {
        "K3": {
            "names": ("large_dqn_fused",),
            "launch_names": ("large_dqn_fused_kernel",),
            "bytes": group * per_member,
            "flops": group * forward_flops(cfg),
            "precision": "bfloat16",
        }
    }
