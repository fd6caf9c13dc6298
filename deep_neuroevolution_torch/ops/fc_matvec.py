"""K7 and K8: the LargeDQN fc race's population mat-vec, y[b] = x[b]·W[b].

``fc_ktiled`` (K7) and ``fc_whole`` (K8) are the wrappers of the CUDA
kernels in csrc/fc_matvec.cu, which replace the TPU kernels ``fc_ktiled``
and ``fc_whole`` of scripts/exp_large_fwd.py; ``fc_ktiled_plain`` and
``fc_whole_plain`` are their plain PyTorch versions: the CPU path and the
yardstick the kernels are held to on the card.

x ``[B, K]`` and W ``[B, K, N]`` are both float32 or both bfloat16; y is
``[B, N]`` float32. K7 cuts K into tiles of ``kt`` rows, sums each tile in
float32 and adds the tiles' sums into y in tile order, starting from 0; K8
is the same with one tile.

On a CUDA tensor the wrapper launches one of two variants, as ``plan``
decides from the shapes, kt, the type, the card's SM count and the
pointers' alignment:

* ``bulk``: W streams through a shared-memory ring fed by the TMA's bulk
  copies (under an L2 evict-first policy: nothing of W is read twice), on
  a persistent grid of ``BLOCKS_PER_SM`` blocks per SM that splits the
  flattened (member, tile, unit) order evenly; no unit straddles a tile.
  Each block writes one partial row per (member, tile) it touches, and a
  second kernel adds a tile's partials in block order and the tiles into y
  in tile order (no float atomics, so a launch repeats its y bit for bit).
* ``general``: what a bulk copy cannot take (see ``plan``): a block per
  (member, column chunk) walking the member's tiles in order.

``fc_ktiled.launches`` and ``fc_whole.launches`` count the calls that
launched a kernel; ``fc_ktiled.launches_by_kt`` splits K7's by tile size,
and ``launches_by_variant`` on each by variant.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from . import _cuda_build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_DTYPE_NAME = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
_TORCH_DTYPE = {name: dt for dt, name in _DTYPE_NAME.items()}
_DTYPE_SIZE = {"float32": 4, "bfloat16": 2}

# The bulk variant's geometry; csrc/fc_matvec.cu has the same constants and
# shared-memory layout.
CONSUMERS = 256  # consumer threads of a block (8 warps), plus one producer warp
BLOCKS_PER_SM = 1  # a block's ~137 KB of shared memory leaves room for no second one
UNIT_BYTES = 32768  # W bytes a unit aims at: R rows of N
STAGES = 4  # ring stages per block: four 32 KB copies in flight per SM (5 or 6 read no faster)
MAX_SMEM = 232_448  # dynamic shared memory a block may have on the H100
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True, eq=False)  # compared and hashed by identity: plan() caches it
class Plan:
    """How one call is launched. ``variant`` is 'bulk' or 'general'; the
    other fields are the bulk variant's and are zero or None for 'general'
    (``reason`` then says why). ``kt`` is the tile, at most K (K8: K).

    Unit u is rows [k0, k0 + r) of member b inside tile t (``unit(u)``):
    ``member_units`` units a member, ``tile_units`` a whole tile, the last
    tile maybe fewer. Block i walks units ``block_units[i]`` to
    ``block_units[i + 1]`` and writes one partial row per (member, tile) it
    touches, from row ``block_segs[i]`` on; segment s = b·tiles + t has
    partial rows ``tile_segs[s]`` to ``tile_segs[s + 1]``, in block order."""

    variant: str
    B: int
    K: int
    N: int
    kt: int
    dtype: str
    sm_count: int
    reason: str = ""
    rows: int = 0
    tiles: int = 0
    tile_units: int = 0
    member_units: int = 0
    grid: int = 0
    stages: int = 0
    row_groups: int = 0
    smem_bytes: int = 0
    block_units: Optional[np.ndarray] = None  # [grid + 1] int32
    block_segs: Optional[np.ndarray] = None  # [grid + 1] int32
    tile_segs: Optional[np.ndarray] = None  # [B·tiles + 1] int32
    # device -> (the table on it, its FcBulkArgs): kept as long as the plan,
    # which plan() keeps for good, so a captured CUDA graph's pointers stay valid
    on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def units(self) -> int:
        return self.B * self.member_units

    @property
    def segments(self) -> int:
        return int(self.tile_segs[-1]) if self.tile_segs is not None else 0

    def unit(self, u):
        """(member, tile, first row, row count) of unit index (or indices)
        ``u``, as the kernel decodes them."""
        return _decode(u, self.K, self.kt, self.rows, self.tile_units, self.member_units)

    def table(self) -> np.ndarray:
        """The int32 array the kernels read: block_units, block_segs and
        tile_segs, end to end."""
        return np.concatenate([self.block_units, self.block_segs, self.tile_segs])

    def bulk_args(self, device: torch.device) -> int:
        """The address of this bulk plan's ``FcBulkArgs`` for ``device``,
        its table copied there on the first call. Callers warm a shape
        before they capture it in a CUDA graph, so the copy runs outside
        any capture."""
        if device not in self.on_device:
            table = torch.from_numpy(self.table()).to(device)
            args = _BulkArgs(table.data_ptr(), self.B, self.K, self.N, self.kt, _DTYPE_CODE[_TORCH_DTYPE[self.dtype]],
                             self.grid, self.rows, self.stages, self.row_groups)
            self.on_device[device] = (table, args)
        return ctypes.addressof(self.on_device[device][1])


def _decode(u, K: int, kt: int, rows: int, tile_units: int, member_units: int):
    """(member, tile, first row, row count) of unit index (or indices) u."""
    u = np.asarray(u, dtype=np.int64)
    b = u // member_units
    v = u - b * member_units
    t = v // tile_units
    k0 = t * kt + (v - t * tile_units) * rows
    return b, t, k0, np.minimum(rows, t * kt + np.minimum(kt, K - t * kt) - k0)


def stage_bytes(rows: int, N: int, size: int) -> int:
    """One ring stage: ``rows`` rows of W, then their x values from the
    16-byte boundary before the first (up to 32 bytes more), each part
    padded to 128 bytes."""
    return -(-rows * N * size // 128) * 128 + -(-(rows * size + 32) // 128) * 128


def smem_bytes(rows: int, N: int, size: int) -> int:
    """A bulk block's dynamic shared memory: the ring of ``STAGES``
    stages, the consumers' reduction buffer and 2·STAGES mbarriers."""
    return STAGES * stage_bytes(rows, N, size) + CONSUMERS * (16 // size) * 4 + 16 * STAGES


@functools.lru_cache(maxsize=None)  # a plan outlives every graph that holds its table's address
def plan(B: int, K: int, N: int, kt: Optional[int], dtype: str, sm_count: int, aligned: bool = True) -> Plan:
    """The launch plan for x ``[B, K]``, W ``[B, K, N]`` of ``dtype``
    ('float32' or 'bfloat16') in tiles of ``kt`` rows (None: K8's one tile)
    on a card with ``sm_count`` SMs. ``aligned`` says that x and W start on
    16-byte boundaries."""
    if kt is not None and kt < 1:
        raise ValueError(f"kt must be at least 1, not {kt}")
    kt = K if kt is None or kt > K else kt
    size = _DTYPE_SIZE[dtype]
    vec = 16 // size
    general = functools.partial(Plan, "general", B, K, N, kt, dtype, sm_count)
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
        return general(reason=f"N > {CONSUMERS * vec}: more column vectors than consumer threads")
    # a multiple of vec keeps a unit's x slice on whole 16-byte vectors;
    # at most 2048 rows (16-byte rows), so the ring fits in MAX_SMEM
    rows = min(max(vec, UNIT_BYTES // (N * size) // vec * vec), kt)
    tiles = -(-K // kt)
    tile_units = -(-kt // rows)
    member_units = (tiles - 1) * tile_units + -(-(K - (tiles - 1) * kt) // rows)
    units = B * member_units
    if units > _INT32_MAX or B * tiles + 1 > _INT32_MAX:
        return general(reason="more units than int32 indices reach")
    grid = min(sm_count * BLOCKS_PER_SM, units)
    block_units = np.arange(grid + 1, dtype=np.int64) * units // grid
    (b0, t0, _, _), (b1, t1, _, _) = (_decode(u, K, kt, rows, tile_units, member_units)
                                      for u in (block_units[:-1], block_units[1:] - 1))
    first, last = b0 * tiles + t0, b1 * tiles + t1  # each block's first and last segment
    block_segs = np.concatenate([[0], np.cumsum(last - first + 1)])
    # segment s's rows: one per block touching s; blocks are in unit order,
    # so a segment's rows are contiguous and the rows sorted by segment
    per_seg = np.zeros(B * tiles + 1, dtype=np.int64)
    np.add.at(per_seg, first, 1)
    np.add.at(per_seg, last + 1, -1)
    tile_segs = np.concatenate([[0], np.cumsum(np.cumsum(per_seg)[:-1])])
    arrays = [a.astype(np.int32) for a in (block_units, block_segs, tile_segs)]
    for a in arrays:
        a.flags.writeable = False  # the cached plan is shared by its callers
    return Plan(
        "bulk", B, K, N, kt, dtype, sm_count, rows=rows, tiles=tiles, tile_units=tile_units,
        member_units=member_units, grid=grid, stages=STAGES, row_groups=CONSUMERS // col_vecs,
        smem_bytes=smem_bytes(rows, N, size), block_units=arrays[0], block_segs=arrays[1], tile_segs=arrays[2],
    )


class _BulkArgs(ctypes.Structure):
    """``FcBulkArgs`` of csrc/fc_matvec.cu: the bulk variant's arguments
    beside the operands."""

    _fields_ = [("plan", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in ("B", "K", "N", "kt", "dtype", "grid", "rows", "stages", "row_groups")]


def check(x: torch.Tensor, W: torch.Tensor) -> torch.device:
    """x ``[B, K]`` and W ``[B, K, N]``, one dtype (float32 or bfloat16),
    one device (cuda or cpu), contiguous; returns the device."""
    if x.dim() != 2 or W.dim() != 3 or tuple(W.shape[:2]) != tuple(x.shape):
        raise ValueError(f"x [B, K] and W [B, K, N] expected, got {tuple(x.shape)} and {tuple(W.shape)}")
    if x.dtype not in _DTYPE_CODE or W.dtype != x.dtype:
        raise TypeError(f"x and W must share float32 or bfloat16, got {x.dtype} and {W.dtype}")
    if x.device != W.device:
        raise ValueError(f"x on {x.device}, W on {W.device}")
    if not (x.is_contiguous() and W.is_contiguous()):
        raise ValueError("x and W must be contiguous")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the fc kernels run on cuda or cpu tensors, not {x.device}")
    return x.device


# (B, K, N, kt, dtype, device, aligned) -> (plan, its FcBulkArgs' address
# on the device or 0): one dictionary lookup a call
_LAUNCHES: dict = {}


def _lookup(x: torch.Tensor, W: torch.Tensor, kt: Optional[int]):
    B, K, N = W.shape
    aligned = x.data_ptr() % 16 == 0 and W.data_ptr() % 16 == 0
    key = (B, K, N, kt, x.dtype, x.device, aligned)
    hit = _LAUNCHES.get(key)
    if hit is None:
        p = plan(B, K, N, kt, _DTYPE_NAME[x.dtype], _cuda_build.sm_count(x.device), aligned)
        hit = _LAUNCHES[key] = (p, p.bulk_args(x.device) if p.variant == "bulk" else 0)
    return hit


def plan_for(x: torch.Tensor, W: torch.Tensor, kt: Optional[int] = None) -> Plan:
    """The plan the wrappers launch for these CUDA tensors (kt None: K8)."""
    return _lookup(x, W, kt)[0]


def _launch(x: torch.Tensor, W: torch.Tensor, p: Plan, args: int) -> torch.Tensor:
    """y on the card by plan ``p`` (``args``: its FcBulkArgs' address on
    x's device), counting nothing: the wrappers count."""
    B, K, N = p.B, p.K, p.N
    dev = x.device
    lib = _cuda_build.load()
    stream = _cuda_build.current_stream(dev)
    if p.variant == "general":
        y = torch.empty((B, N), dtype=torch.float32, device=dev)
        code = _DTYPE_CODE[x.dtype]
        if p.kt == K:
            err = lib.nevo_fc_whole(x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, code, stream)
        else:
            err = lib.nevo_fc_ktiled(x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, p.kt, code, stream)
        _cuda_build.check(lib, err, "fc_matvec (general)")
        return y
    # y and the partial rows in one allocation; B·N·4 bytes keep the
    # partials 16-byte aligned, as N·4 % 16 == 0 here
    buf = torch.empty((B + p.segments, N), dtype=torch.float32, device=dev)
    ptr = buf.data_ptr()
    err = lib.nevo_fc_bulk(x.data_ptr(), W.data_ptr(), ptr + B * N * 4, ptr, args, stream)
    _cuda_build.check(lib, err, "fc_matvec (bulk)")
    return buf[:B]


def fc_ktiled_plain(x: torch.Tensor, W: torch.Tensor, kt: int) -> torch.Tensor:
    """K7's plain version: each tile of ``kt`` rows one f32 ``torch.bmm``,
    added into y in tile order."""
    B, K = x.shape
    y = torch.zeros((B, W.shape[2]), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, kt):
        y = y + torch.bmm(x[:, None, k0:k0 + kt].float(), W[:, k0:k0 + kt].float())[:, 0]
    return y


def fc_ktiled(x: torch.Tensor, W: torch.Tensor, kt: int) -> torch.Tensor:
    """K7: y[b] = x[b]·W[b] ``[B, K]·[B, K, N]`` → ``[B, N]`` f32, K in
    tiles of ``kt`` rows whose f32 partials are added into y in tile order.
    A CUDA tensor launches a kernel (the variant ``plan_for`` names); a CPU
    tensor runs the plain version."""
    dev = check(x, W)
    if kt < 1:
        raise ValueError(f"kt must be at least 1, not {kt}")
    if dev.type == "cpu":
        return fc_ktiled_plain(x, W, kt)
    B, K = x.shape
    N = W.shape[2]
    if K == 0:
        return torch.zeros((B, N), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return torch.empty((B, N), dtype=torch.float32, device=dev)
    p, args = _lookup(x, W, kt)
    y = _launch(x, W, p, args)
    fc_ktiled.launches += 1
    fc_ktiled.launches_by_kt[kt] += 1
    fc_ktiled.launches_by_variant[p.variant] += 1
    return y


# kernel launches since the caller last set it to 0; the same launches by
# tile size kt and by variant (a caller that zeroes .launches clears them too)
fc_ktiled.launches = 0
fc_ktiled.launches_by_kt = collections.Counter()
fc_ktiled.launches_by_variant = collections.Counter()


def fc_whole_plain(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K8's plain version: one f32 ``torch.bmm``."""
    return torch.bmm(x[:, None, :].float(), W.float())[:, 0]


def fc_whole(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K8: y[b] = x[b]·W[b] ``[B, K]·[B, K, N]`` → ``[B, N]`` f32, K7 at
    one tile. A CUDA tensor launches a kernel (the variant ``plan_for``
    names); a CPU tensor runs the plain version."""
    dev = check(x, W)
    if dev.type == "cpu":
        return fc_whole_plain(x, W)
    B, N = x.shape[0], W.shape[2]
    if B == 0 or N == 0:
        return torch.empty((B, N), dtype=torch.float32, device=dev)
    p, args = _lookup(x, W, None)
    y = _launch(x, W, p, args)
    fc_whole.launches += 1
    fc_whole.launches_by_variant[p.variant] += 1
    return y


fc_whole.launches = 0  # kernel launches since the caller last set it to 0
fc_whole.launches_by_variant = collections.Counter()  # the same by variant
