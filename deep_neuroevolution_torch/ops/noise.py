"""Shared Gaussian noise table, resident on the device.

The counterpart of the JAX package's ops/noise.py ``NoiseTable``. The
reference (es_distributed/es.py:51-67) draws 250M standard normals with
``np.random.RandomState(123).randn`` and converts them to float32;
``from_seed`` does exactly that, so the table is bit-identical to the JAX
package's. Perturbations are start offsets into the table: row ``i`` is
``noise[i : i + dim]``.

Offsets are **unaligned**: ``sample_index_batch`` draws uniformly over
every valid start ``[0, size - dim]``, as the reference does. The JAX
package quantizes offsets to 1024 when its Pallas gradient is on
(``use_pallas_grad``), because Mosaic needs aligned DMA offsets; the port's
gradient kernel (csrc/noise_gradient.cu) takes any offset, so that
alignment is not carried over.

Index draws use an explicit CPU ``torch.Generator``, never the global RNG.

``noise_rows`` is the JAX package's ``noise_rows`` for a materialized
table (noise.py:152-166): rows at start offsets, each offset clamped to the
last valid start as ``lax.dynamic_slice`` clamps it. Not ported yet:
``VirtualNoise`` and ``from_key``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DEFAULT_COUNT = 250_000_000  # reference: es_distributed/es.py:55
DEFAULT_SEED = 123  # reference: es_distributed/es.py:54


@dataclasses.dataclass(frozen=True)
class NoiseTable:
    """Device-resident shared noise table."""

    noise: torch.Tensor  # [count] float32

    @classmethod
    def from_seed(
        cls,
        count: int = DEFAULT_COUNT,
        seed: int = DEFAULT_SEED,
        device: Optional[torch.device] = None,
    ) -> "NoiseTable":
        """The reference's table: ``RandomState(seed).randn(count)`` cast to
        float32 (es.py:60). At the default count this is a 2 GB float64
        array on the host for a moment; callers that need less pass a
        smaller ``count``."""
        host = np.random.RandomState(seed).randn(count).astype(np.float32)
        return cls(torch.from_numpy(host).to(device or "cpu"))

    @property
    def size(self) -> int:
        return int(self.noise.shape[0])

    def get(self, i: int, dim: int) -> torch.Tensor:
        """``noise[i : i + dim]`` (a view)."""
        i = int(i)
        if i < 0 or i + dim > self.size:
            raise IndexError(f"noise row [{i}, {i + dim}) outside table of {self.size}")
        return self.noise[i : i + dim]

    def get_batch(self, idxs: torch.Tensor, dim: int) -> torch.Tensor:
        """Stacked rows ``[B, dim]`` for start offsets ``idxs [B]``."""
        rows = self.noise.as_strided((self.size - dim + 1, dim), (1, 1))  # every row, no copy
        return rows[idxs.to(device=self.noise.device, dtype=torch.int64)]

    def sample_index_batch(self, gen: torch.Generator, dim: int, n: int) -> torch.Tensor:
        """``n`` start offsets, uniform over ``[0, size - dim]`` inclusive
        (es.py:66-67), as int32 on the CPU."""
        if self.size < dim:
            raise ValueError(f"noise table ({self.size}) smaller than dim ({dim})")
        return torch.randint(0, self.size - dim + 1, (n,), generator=gen, dtype=torch.int64).to(
            torch.int32
        )


def noise_rows(table: torch.Tensor, idxs: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, dim]`` rows ``table[i : i + dim]`` of a ``[count]`` table for
    start offsets ``idxs [B]``, on the table's device. Offsets outside
    ``[0, count - dim]`` are clamped into it (``lax.dynamic_slice``'s rule)."""
    count = int(table.shape[0])
    if count < dim:
        raise ValueError(f"noise table ({count}) smaller than dim ({dim})")
    idxs = idxs.to(device=table.device, dtype=torch.int64).clamp(0, count - dim)
    return NoiseTable(table).get_batch(idxs, dim)
