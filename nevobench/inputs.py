"""Inputs made from the run's seed, on the run's device, in a few large
calls: frames, the reference batch and the population's θ.

The same seed gives the same inputs on one device. Both the program and
the reference are handed these tensors; neither makes its own.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .reference import common


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number ≥ 0;
    larger ones are taken modulo 2⁶⁴)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


def gray_frames(gen: torch.Generator, shape: Sequence[int], cell: Sequence[int], device) -> torch.Tensor:
    """uint8 gray frames ``[*shape[:-2], H, W]`` of uniform random blocks of
    ``cell`` pixels (H and W multiples of the cell): coarse enough that
    frames move a policy's actions the way screens do, and distinct in
    every frame and member."""
    *lead, h, w = shape
    ch, cw = cell
    coarse = torch.randint(0, 256, (*lead, h // ch, w // cw), generator=gen, device=device, dtype=torch.uint8)
    return coarse.repeat_interleave(ch, dim=-2).repeat_interleave(cw, dim=-1)


def members(gen: torch.Generator, specs, n: int, init: dict, device) -> torch.Tensor:
    """θ ``[n, D]`` float32 of the population.

    ``init['kind']``: 'perturbed' is ES's θ₀ + σ·ε, one normc θ₀ shared by
    the members; 'independent' is the GA's n genomes, each weight drawn at
    std·scale (``init['scale']``: 'fan_in', the GPU stack's genome scale)
    plus one mutation σ·ε, each bias σ·ε. σ is ``init['sigma']``."""
    D = common.total_dim(specs)
    sigma = float(init["sigma"])
    if init["kind"] == "perturbed":
        theta0 = common.normc_(torch.randn((1, D), generator=gen, device=device), specs)
        thetas = torch.randn((n, D), generator=gen, device=device)
        return thetas.mul_(sigma).add_(theta0)
    if init["kind"] == "independent":
        thetas = torch.randn((n, D), generator=gen, device=device)
        for off, size, scale in common.init_scale(specs, init["scale"]):
            # the sum of two independent Gaussians: one draw at their joint std
            thetas[:, off:off + size].mul_((scale * scale + sigma * sigma) ** 0.5)
        return thetas
    raise ValueError(f"unknown members kind {init['kind']!r}")
