"""ModelVirtualBN, ES's Atari policy (configs/vbn_dqn_es.json), on the
program's 'auto' route: the split route, convs as batched products and the
fc through K1, in float32.

What the benchmark makes for it from the seed: θ₀ + σ·ε for each member and
a reference batch of frame stacks; the program works out the members'
virtual-batch-norm moments from that batch at set-up (``batch_ref_stats``),
and the reference works them out again.
"""

from __future__ import annotations

import torch

from nevobench import inputs
from nevobench.reference import common, vbn_dqn


def make_inputs(cfg: dict, traffic: dict, n: int, gen: torch.Generator, device) -> dict:
    """θ of ``n`` members and what else the configuration's forward takes."""
    thetas = inputs.members(gen, vbn_dqn.layout(cfg), n, cfg["members"], device)
    r = cfg["ref_batch_size"]
    frames = inputs.gray_frames(gen, (r * cfg["in_ch"], 2, *traffic["frame_hw"]), traffic["frame_cell"], device)
    ref_batch = common.preprocess_gray(frames, cfg["in_hw"]).reshape(r, cfg["in_ch"], cfg["in_hw"], cfg["in_hw"])
    return {"thetas": thetas, "ref_batch": ref_batch}


def program(cfg: dict):
    from deep_neuroevolution_torch.models import get_model

    return get_model(cfg["model"])(**cfg["model_kwargs"])


def program_params(model, inp: dict):
    """``(thetas, stats)`` as the ES trainer hands them to a rollout: the
    moments from the program's own reference-batch pass (NHWC frames)."""
    stats = model.batch_ref_stats(inp["thetas"], inp["ref_batch"].permute(0, 2, 3, 1).contiguous())
    return inp["thetas"], stats


def reference(cfg: dict, inp: dict):
    """The reference's scores of the members: a function of stacks ``[P,
    B, 4, 84, 84]`` → ``[P, B, A]``, float32."""
    return vbn_dqn.scorer(inp["thetas"], inp["ref_batch"], cfg)


def products(cfg: dict):
    """(rows, depth, columns) of each product of one member's forward of
    one frame stack: conv1 and conv2 as im2col products, the fc, the out
    layer."""
    h1, h2 = cfg["conv1_out_hw"], cfg["conv2_out_hw"]
    c1, c2 = cfg["conv1_channels"], cfg["conv2_channels"]
    return [
        (h1 * h1, cfg["conv1_kernel"] ** 2 * cfg["in_ch"], c1),
        (h2 * h2, cfg["conv2_kernel"] ** 2 * c1, c2),
        (1, h2 * h2 * c2, cfg["fc_units"]),
        (1, cfg["fc_units"], cfg["num_actions"]),
    ]


def forward_flops(cfg: dict) -> int:
    """FLOPs (2 a multiply-add) of one member's forward of one frame stack.
    The normalizations' elementwise work, under 0.3% of it, is not
    counted."""
    return 2 * sum(m * k * n for m, k, n in products(cfg))


def kernels(cfg: dict, group: int) -> dict:
    """The hand-written kernels of one group's forward (``group`` members):
    K1, the fc, x ``[group, K]`` · W ``[group, K, N]`` → y ``[group, N]``,
    all float32. Its bytes: each input byte read once, y written once."""
    _, K, N = products(cfg)[2]
    return {
        "K1": {
            "names": ("population_linear",),
            "launch_names": ("population_linear_bulk_kernel", "population_linear_kernel"),
            "bytes": 4 * (group * K + group * K * N + group * N),
            "flops": 2 * group * K * N,
            "precision": "float32",
        }
    }
