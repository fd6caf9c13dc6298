"""K1: the population fc layer, y[b] = x[b]·W[b].

``population_linear`` is the wrapper of the CUDA kernels in
csrc/population_linear.cu, which replace the TPU kernel of the JAX
package's ops/pallas_forward.py. ``population_linear_plain`` is its plain
PyTorch version: the CPU path and the yardstick the kernels are held to on
the card.

x ``[B, K]`` and W ``[B, K, N]`` are both float32 or both bfloat16; y is
``[B, N]`` float32, accumulated in float32. Any B, K and N.

On a CUDA tensor the wrapper launches one of two variants, as ``plan``
decides from the shapes, the type, the card's SM count and the pointers'
alignment:

* ``bulk``: W streams through a shared-memory ring fed by the TMA's bulk
  copies, on a persistent grid of ``BLOCKS_PER_SM`` blocks per SM that
  splits the flattened (member, K-chunk) units evenly, then a second pass
  sums each member's partial rows in a fixed order (no float atomics, so a
  launch repeats its y bit for bit). The plan is computed here, in Python.
* ``general``: what a bulk copy cannot take (see ``plan``), one block per
  (member, N tile).

``population_linear.launches`` counts the calls that launched a kernel;
``bulk_launches`` and ``general_launches`` split that count by variant, and
``launches_by_batch`` by (B, variant).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import _cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_DTYPE_SIZE = {"float32": 4, "bfloat16": 2}

# The bulk variant's geometry; csrc/population_linear.cu has the same
# constants and shared-memory layout.
CONSUMERS = 256  # consumer threads of a block (8 warps), plus one producer warp
BLOCKS_PER_SM = 1  # a block's 133 KB of shared memory leaves room for no second one
UNIT_BYTES = 32768  # W bytes a unit aims at: R rows of N
STAGES = 4  # ring stages per block: four 32 KB copies in flight per SM


@dataclasses.dataclass(frozen=True, eq=False)  # compared and hashed by identity: plan() caches it
class Plan:
    """How one call is launched. ``variant`` is 'bulk' or 'general'; the
    other fields are the bulk variant's and are zero or None for 'general'
    (``reason`` then says why).

    Unit u is rows [c·rows, min((c + 1)·rows, K)) of member u // chunks,
    c = u % chunks. Block i walks units ``block_units[i]`` to
    ``block_units[i + 1]`` and writes one partial row per member it
    touches, from row ``block_segs[i]`` on; member b's partial rows are
    ``member_segs[b]`` to ``member_segs[b + 1]``, in block order."""

    variant: str
    B: int
    K: int
    N: int
    dtype: str
    sm_count: int
    reason: str = ""
    rows: int = 0
    chunks: int = 0
    grid: int = 0
    stages: int = 0
    row_groups: int = 0
    smem_bytes: int = 0
    block_units: Optional[np.ndarray] = None  # [grid + 1] int32
    block_segs: Optional[np.ndarray] = None  # [grid + 1] int32
    member_segs: Optional[np.ndarray] = None  # [B + 1] int32

    @property
    def units(self) -> int:
        return self.B * self.chunks

    @property
    def segments(self) -> int:
        return int(self.member_segs[-1]) if self.member_segs is not None else 0

    def table(self) -> np.ndarray:
        """The int32 array the kernels read: block_units, block_segs,
        member_segs, end to end."""
        return np.concatenate([self.block_units, self.block_segs, self.member_segs])


def stage_bytes(rows: int, N: int, size: int) -> int:
    """One ring stage: ``rows`` rows of W, then their x values, each part
    padded to 128 bytes."""
    return -(-rows * N * size // 128) * 128 + -(-rows * size // 128) * 128


def smem_bytes(rows: int, N: int, size: int, stages: int) -> int:
    """A bulk block's dynamic shared memory: the ring, the consumers'
    reduction buffer, 2·stages mbarriers."""
    return stages * stage_bytes(rows, N, size) + CONSUMERS * (16 // size) * 4 + 16 * stages


@functools.lru_cache(maxsize=128)
def plan(B: int, K: int, N: int, dtype: str, sm_count: int, aligned: bool = True) -> Plan:
    """The launch plan for x ``[B, K]``, W ``[B, K, N]`` of ``dtype``
    ('float32' or 'bfloat16') on a card with ``sm_count`` SMs. ``aligned``
    says that x and W start on 16-byte boundaries."""
    size = _DTYPE_SIZE[dtype]
    vec = 16 // size
    general = functools.partial(Plan, "general", B, K, N, dtype, sm_count)
    if B <= 0 or N <= 0:
        return general(reason="empty output")
    if K <= 0:
        return general(reason="K = 0: nothing to stream")
    if not aligned:
        return general(reason="x or W is not 16-byte aligned")
    if (N * size) % 16 or (K * size) % 16:
        return general(reason="a row of W or of x is not a multiple of 16 bytes")
    col_vecs = N // vec  # a consumer thread owns one 16-byte column vector
    if col_vecs > CONSUMERS:
        return general(reason=f"N > {CONSUMERS * vec}: more columns than consumer threads")
    row_bytes = N * size
    rows = max(vec, UNIT_BYTES // row_bytes // vec * vec)  # a multiple of vec keeps x's slice 16-byte aligned
    rows = min(rows, K)  # K is a multiple of vec here
    chunks = -(-K // rows)
    units = B * chunks
    grid = min(sm_count * BLOCKS_PER_SM, units)
    block_units = np.arange(grid + 1, dtype=np.int64) * units // grid
    first = block_units[:-1] // chunks
    last = (block_units[1:] - 1) // chunks
    touched = last - first + 1
    block_segs = np.concatenate([[0], np.cumsum(touched)])
    # member b's rows: one per block touching b; blocks are in unit order,
    # so a member's rows are contiguous and the segment rows sorted by member
    per_member = np.zeros(B + 1, dtype=np.int64)
    np.add.at(per_member, first, 1)
    np.add.at(per_member, last + 1, -1)
    member_segs = np.concatenate([[0], np.cumsum(np.cumsum(per_member)[:-1])])
    arrays = [a.astype(np.int32) for a in (block_units, block_segs, member_segs)]
    for a in arrays:
        a.flags.writeable = False  # the cached plan is shared by its callers
    return Plan(
        "bulk", B, K, N, dtype, sm_count, rows=rows, chunks=chunks, grid=grid, stages=STAGES,
        row_groups=CONSUMERS // col_vecs, smem_bytes=smem_bytes(rows, N, size, STAGES),
        block_units=arrays[0], block_segs=arrays[1], member_segs=arrays[2],
    )


@functools.lru_cache(maxsize=128)
def _device_table(p: Plan, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(p.table()).to(device)


def population_linear_plain(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bk,bkn->bn", x.float(), W.float())


def _check(x: torch.Tensor, W: torch.Tensor) -> None:
    if x.ndim != 2 or W.ndim != 3 or tuple(x.shape) != tuple(W.shape[:2]):
        raise ValueError(f"population_linear needs x [B, K] and W [B, K, N], got {tuple(x.shape)}, {tuple(W.shape)}")
    if x.dtype != W.dtype or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x and W must both be float32 or both bfloat16, got {x.dtype}, {W.dtype}")
    if x.device != W.device:
        raise ValueError(f"x and W on different devices: {x.device}, {W.device}")
    if not (x.is_contiguous() and W.is_contiguous()):
        raise ValueError("population_linear needs contiguous x and W")


def plan_for(x: torch.Tensor, W: torch.Tensor) -> Plan:
    """The plan ``population_linear`` launches for these CUDA tensors."""
    B, K, N = W.shape
    aligned = x.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0
    return plan(B, K, N, _DTYPE_NAME[x.dtype], _cuda_build.sm_count(x.device), aligned)


def population_linear(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """y[b] = x[b]·W[b]. A CUDA tensor launches a kernel (the variant
    ``plan_for`` names); a CPU tensor runs the plain version; any other
    device raises."""
    _check(x, W)
    if x.device.type == "cpu":
        return population_linear_plain(x, W)
    if x.device.type != "cuda":
        raise ValueError(f"population_linear runs on cuda or cpu tensors, not {x.device}")
    B, K, N = W.shape
    if B == 0 or N == 0:
        return torch.empty((B, N), dtype=torch.float32, device=x.device)
    lib = _cuda_build.load()
    p = plan_for(x, W)
    stream = _cuda_build.current_stream(x.device)
    if p.variant == "bulk":
        table = _device_table(p, x.device)
        # y and the partial rows in one allocation (a host cost per call);
        # B·N·4 bytes keep the partials 16-byte aligned, as N·4 % 16 == 0 here
        buf = torch.empty((B + p.segments, N), dtype=torch.float32, device=x.device)
        y = buf[:B]
        err = lib.nevo_population_linear_bulk(
            x.data_ptr(), W.data_ptr(), buf.data_ptr() + B * N * 4, buf.data_ptr(), table.data_ptr(), B, K, N,
            _DTYPE_CODE[x.dtype], p.grid, p.rows, p.chunks, p.stages, p.row_groups, stream,
        )
        _cuda_build.check(lib, err, "population_linear (bulk)")
        population_linear.bulk_launches += 1
    else:
        y = torch.empty((B, N), dtype=torch.float32, device=x.device)
        err = lib.nevo_population_linear(
            x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, _DTYPE_CODE[x.dtype], stream,
        )
        _cuda_build.check(lib, err, "population_linear (general)")
        population_linear.general_launches += 1
    population_linear.launches += 1
    population_linear.launches_by_batch[(B, p.variant)] += 1
    return y


# kernel launches since the caller last set them to 0: all, by variant, and
# by (B, variant)
population_linear.launches = 0
population_linear.bulk_launches = 0
population_linear.general_launches = 0
population_linear.launches_by_batch = collections.Counter()


def bulk_blocks_per_sm(dtype: torch.dtype, smem: int) -> int:
    """How many bulk blocks with ``smem`` bytes of dynamic shared memory
    the card fits on one SM (needs the card)."""
    lib = _cuda_build.load()
    n = lib.nevo_population_linear_bulk_occupancy(_DTYPE_CODE[dtype], smem)
    if n < 0:
        _cuda_build.check(lib, -n, "population_linear occupancy")
    return n
