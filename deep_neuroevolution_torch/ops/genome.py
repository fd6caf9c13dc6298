"""Seed-chain genomes: GA individuals as noise indices.

The counterpart of the JAX package's ops/genome.py. GPU-style chains (gpu
neuroevolution/models/base.py:127-156): the first entry is the init index,
each later entry an (index, power) mutation, and

    θ₀ = ε(idx₀)·scale_by,   θ ← θ + powerₖ·ε(idxₖ),

with ε(i) = table[i : i + D], or row i of a ``VirtualNoise`` (ops/noise.py
``noise_rows``; every function here takes a table tensor or either
source). A population of
chains is one ``[P, L]`` index array and one ``[P, L]`` power array, padded
with (0, 0) entries, which add 0·ε = 0.

CPU-style chains (es_distributed/ga.py:250-264) are bare indices:
θ₀ = reinit(ε(idx₀)), the model's normalized-column re-init
(``Model.reinit_theta``), then θ ← θ + σ·ε(idxₖ) with one global σ
(``noise_stdev``): ``reconstruct_cpu_style``.

Each mutation step θ + power·ε is one fused multiply-add, rounded to f32
once, because XLA fuses the JAX package's step into an FMA (its θ differs
from a separately rounded product and sum by an ulp on ~5% of entries).
``mutate_`` computes it in float64, where power·ε is exact, and rounds the
sum to f32: that is the FMA's result except where the float64 sum falls on
a float32 rounding tie (about one entry in 2^29). So a θ is the JAX
package's bit for bit, on the CPU and on the card alike. The JAX package
rebuilds a whole CPU-style chain eagerly, with no fusion: the product σ·ε
and the sum are rounded to f32 one after the other, and
``reconstruct_cpu_style`` rounds them so too.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .noise import noise_row, noise_rows


_CHUNK = 1 << 24  # elements per float64 pass of mutate_ (128 MB of float64)


def mutate_(theta: torch.Tensor, power, eps: torch.Tensor) -> torch.Tensor:
    """θ ← θ + power·ε in place, one f32 rounding (see the module
    docstring). ``theta`` and ``eps`` are ``[D]`` or ``[B, D]`` f32;
    ``power`` is a number, or ``[B, 1]`` f32 for per-row powers. Works in
    row chunks so the float64 copies stay small."""
    rows, e = theta.view(-1, theta.shape[-1]), eps.view(-1, eps.shape[-1])
    if not isinstance(power, torch.Tensor):
        power = torch.tensor(float(np.float32(power)), dtype=torch.float64, device=theta.device)
    step = max(1, _CHUNK // rows.shape[1])
    for s in range(0, rows.shape[0], step):
        p = power[s : s + step] if power.ndim else power
        rows[s : s + step].copy_(rows[s : s + step].double().addcmul_(e[s : s + step].double(), p.double()))
    return theta


def reconstruct_gpu_style(
    table,  # [count] noise table tensor, a NoiseTable or a VirtualNoise
    chain_idxs: torch.Tensor,  # [L] int; entry 0 = init index
    chain_powers: torch.Tensor,  # [L] f32; entry 0 ignored, 0 = padding
    dim: int,
    scale_by: Optional[torch.Tensor] = None,  # [D] per-parameter init scale
) -> torch.Tensor:
    """θ ``[D]`` from one chain (base.py:139-145)."""
    return reconstruct_gpu_style_batch(table, chain_idxs[None], chain_powers[None], dim, scale_by)[0]


def reconstruct_gpu_style_batch(
    table,
    chains_idxs: torch.Tensor,  # [P, L]
    chains_powers: torch.Tensor,  # [P, L]
    dim: int,
    scale_by: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """θ ``[P, D]`` for a padded population of chains, one chain position
    at a time for all P."""
    powers = chains_powers.to(device=table.device, dtype=torch.float32)
    theta = noise_rows(table, chains_idxs[:, 0], dim)
    if scale_by is not None:
        theta = theta * scale_by.to(table.device)
    for k in range(1, chains_idxs.shape[1]):
        mutate_(theta, powers[:, k, None], noise_rows(table, chains_idxs[:, k], dim))
    return theta


def extend(theta_parent: torch.Tensor, table, idx: int, power: float, dim: int) -> torch.Tensor:
    """One mutation from a cached parent θ (base.py:148-156)."""
    return mutate_(theta_parent.clone(), power, noise_row(table, idx, dim))


def reconstruct_cpu_style(
    table, chain: Sequence[int], dim: int, reinit, noise_stdev: float
) -> torch.Tensor:
    """θ ``[D]`` of a CPU-style chain ``(idx₀, idx, ...)``: ``reinit`` (the
    model's ``reinit_theta``) of ε(idx₀), then θ + σ·ε(idx) for each later
    index, σ·ε and the sum each rounded to f32 (the JAX package's
    algos/ga.py:309-311 and utils/checkpoint.py:93-95)."""
    sigma = float(np.float32(noise_stdev))
    theta = reinit(noise_row(table, chain[0], dim))
    for idx in chain[1:]:
        theta = theta + noise_row(table, idx, dim) * sigma
    return theta


def pad_chains(chains: Sequence[Sequence], max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged chains ``[idx₀, (idx, power), ...]`` → ``([P, max_len] int32
    indices, [P, max_len] f32 powers)``, zero-padded. A bare index gets
    power 1.0, a slot marker that reconstruction reads only after entry 0."""
    P = len(chains)
    idxs = np.zeros((P, max_len), np.int32)
    powers = np.zeros((P, max_len), np.float32)
    for p, chain in enumerate(chains):
        if len(chain) > max_len:
            raise ValueError(f"chain {p} longer than max_len={max_len}")
        for pos, entry in enumerate(chain):
            if isinstance(entry, (tuple, list)):
                idxs[p, pos], powers[p, pos] = entry[0], entry[1]
            else:
                idxs[p, pos] = entry
                powers[p, pos] = 1.0
    return torch.from_numpy(idxs), torch.from_numpy(powers)
