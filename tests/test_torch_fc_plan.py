"""K7's and K8's launch plan (ops/fc_matvec.py ``plan``), on the CPU.

The bulk variant's kernels run only on a card, but the plan they follow is
Python: which variant a shape takes, how the flattened (member, tile, unit)
order is split between the persistent blocks, and where each block's
partial rows go. These tests check that every (member, row of K) is summed
exactly once, that no unit straddles a tile, that the blocks' loads differ
by at most one unit, and, by a float32 emulation that sums in the kernels'
order (each unit's rows by row group, a block's units of one tile into one
partial row, a tile's partials in block order, the tiles into y in tile
order from 0), that the plan computes y: against the plain versions and
against the JAX script's Pallas kernels in interpret mode, within
1e-5·max|y| (float32 sums in another order; bf16 products are exact in
float32)."""

import ctypes
import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deep_neuroevolution_torch.ops import fc_matvec as fm

ROOT = Path(__file__).resolve().parents[1]
SIZE = {"float32": 4, "bfloat16": 2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
K = 296  # a small K whose rows of x are whole 16-byte vectors in either type


def _jax_script():
    spec = importlib.util.spec_from_file_location("_exp_large_fwd", ROOT / "scripts" / "exp_large_fwd.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


exp_j = _jax_script()


@pytest.fixture
def interpret(monkeypatch):
    """The JAX script's Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _check_bulk_plan(p):
    B, K, N, kt, size = p.B, p.K, p.N, p.kt, SIZE[p.dtype]
    bu, bs, ts = (a.astype(np.int64) for a in (p.block_units, p.block_segs, p.tile_segs))
    assert p.tiles == -(-K // kt) and 1 <= p.rows <= kt
    assert p.grid == min(p.sm_count * fm.BLOCKS_PER_SM, p.units) and bu.shape == (p.grid + 1,)
    assert bu[0] == 0 and bu[-1] == p.units
    loads = np.diff(bu)
    assert loads.min() >= 1 and loads.max() - loads.min() <= 1  # balanced to one unit
    b, t, k0, r = p.unit(np.arange(p.units))
    assert (r >= 1).all() and (r <= p.rows).all()
    # no unit straddles a tile: its rows lie in [t·kt, min((t + 1)·kt, K))
    assert (k0 >= t * kt).all() and (k0 + r <= np.minimum((t + 1) * kt, K)).all()
    # every (member, row) covered exactly once, and only rows inside K
    cover = np.zeros((B, K), np.int32)
    rows = np.repeat(k0, r) + np.arange(r.sum()) - np.repeat(np.cumsum(r) - r, r)
    np.add.at(cover, (np.repeat(b, r), rows), 1)
    assert (cover == 1).all()
    # the tail tile's rows are exactly those inside K
    tail = t == p.tiles - 1
    assert k0[tail].min() == (p.tiles - 1) * kt and (k0 + r)[tail].max() == K
    # a unit is whole but for a tile's last; units run in member, tile order
    seg = b * p.tiles + t
    assert (np.diff(seg) >= 0).all() and np.array_equal(np.unique(seg), np.arange(B * p.tiles))
    short = r < p.rows
    assert (np.diff(seg)[short[:-1]] == 1).all()  # a short unit ends its tile
    # bulk copies: W's rows 16-byte sized, x's slice widened to 16 bytes
    assert (N * size) % 16 == 0 and (K * size) % 16 == 0
    # the segment maps: block i's partial rows follow its (member, tile)
    # segments in order; segment s's rows are the blocks touching s, in
    # block order
    first, last = seg[bu[:-1]], seg[bu[1:] - 1]
    assert bs[0] == 0 and (np.diff(bs) == last - first + 1).all()
    seg_of_row = np.concatenate([np.arange(f, l + 1) for f, l in zip(first, last)])
    assert len(seg_of_row) == p.segments == bs[-1] == ts[-1]
    assert (np.diff(seg_of_row) >= 0).all()
    assert (np.bincount(seg_of_row, minlength=B * p.tiles) == np.diff(ts)).all()
    # shared memory: one block an SM inside the H100's 227 KB
    assert p.stages == fm.STAGES and p.smem_bytes == fm.smem_bytes(p.rows, N, size) <= fm.MAX_SMEM
    vecs = N * size // 16
    assert vecs <= fm.CONSUMERS and p.row_groups == fm.CONSUMERS // vecs


@pytest.mark.parametrize("sm_count", [1, 3, 7, 132])
@pytest.mark.parametrize("B", [1, 5, 133])
@pytest.mark.parametrize("N,dtype", [(n, d) for n in (37, 200, 512) for d in ("float32", "bfloat16")])
def test_plan_covers_every_row_once(N, dtype, B, sm_count):
    """At kt 1, 7, R − 1, R, R + 1, K and past K (and K8's None): every
    (b, k) row summed once, no unit across a tile, the loads balanced to a
    unit, the segments in member and tile order; N = 37 (rows not whole
    16-byte vectors) takes 'general'."""
    R = fm.plan(B, K, N, None, dtype, sm_count).rows
    for kt in (1, 7, R - 1, R, R + 1, K, K + 5, None):
        if kt is not None and kt < 1:
            continue
        p = fm.plan(B, K, N, kt, dtype, sm_count)
        if N == 37:
            assert p.variant == "general" and "16 bytes" in p.reason
            assert p.block_units is None and p.segments == 0
            continue
        assert p.variant == "bulk", (kt, p.reason)
        assert p.kt == (K if kt is None else min(kt, K))
        _check_bulk_plan(p)


def test_race_and_odd_shapes():
    """The race's shape: 32-row units (32 KB), whole at every tile, 132
    blocks at any B; the odd shape (5, 5000, 200): 80-row units, every
    tile ending in a short one."""
    for kt in (1024, 2048, 3872, None):
        for B in (1, 8, 32, 128, 256):
            p = fm.plan(B, 7744, 512, kt, "bfloat16", 132)
            assert p.variant == "bulk" and p.rows == 32 and p.rows * 512 * 2 == fm.UNIT_BYTES
            assert p.grid == min(132, p.units) and (p.kt % p.rows == 0)
        p = fm.plan(5, 5000, 200, kt, "bfloat16", 132)
        assert p.variant == "bulk" and p.rows == 80 and p.grid == 132
        b, t, k0, r = p.unit(np.arange(p.units))
        seg = b * p.tiles + t
        ends = np.r_[np.diff(seg) > 0, True]
        assert (r[ends] < 80).all() and (r[~ends] == 80).all()


def test_each_general_reason():
    """Every reason the bulk variant refuses a shape, and its words."""
    reasons = {
        fm.plan(2, 0, 512, None, "bfloat16", 132).reason: "K = 0",
        fm.plan(2, 296, 512, 8, "bfloat16", 132, aligned=False).reason: "aligned",
        fm.plan(2, 296, 37, 8, "bfloat16", 132).reason: "16 bytes",
        fm.plan(2, 297, 512, 8, "bfloat16", 132).reason: "16 bytes",  # a row of x: 594 bytes
        fm.plan(2, 296, 2056, 8, "bfloat16", 132).reason: "column vectors",
        fm.plan(2, 296, 1028, 8, "float32", 132).reason: "column vectors",
        fm.plan(0, 296, 512, 8, "float32", 132).reason: "empty",
    }
    for reason, words in reasons.items():
        assert words in reason, reason
    assert fm.plan(2, 296, 2048, 8, "bfloat16", 132).variant == "bulk"
    assert fm.plan(2, 296, 1024, 8, "float32", 132).variant == "bulk"
    with pytest.raises(ValueError):
        fm.plan(2, 296, 512, 0, "float32", 132)
    # the largest ring: rows of one 16-byte vector, 2048 of them a unit
    for dtype, n in (("float32", 4), ("bfloat16", 8)):
        p = fm.plan(2, 4096, n, None, dtype, 132)
        assert p.variant == "bulk" and p.rows == 2048 and p.smem_bytes <= fm.MAX_SMEM


def test_bulk_args_kept_with_plan():
    """A plan is cached for good and keeps its table and ``FcBulkArgs`` for
    each device it was launched on, so the address a CUDA graph captured
    stays valid: the same plan object and the same address call after
    call, the table the plan's, the arguments its fields."""
    p = fm.plan(3, 296, 200, 64, "bfloat16", 7)
    assert fm.plan(3, 296, 200, 64, "bfloat16", 7) is p
    cpu = torch.device("cpu")
    addr = p.bulk_args(cpu)
    assert p.bulk_args(cpu) == addr and len(p.on_device) == 1
    table, args = p.on_device[cpu]
    assert ctypes.addressof(args) == addr and args.plan == table.data_ptr()
    assert np.array_equal(table.numpy(), p.table()) and len(p.table()) == 2 * (p.grid + 1) + p.B * p.tiles + 1
    assert (args.B, args.K, args.N, args.kt, args.dtype, args.grid, args.rows, args.stages, args.row_groups) == (
        p.B, p.K, p.N, p.kt, 1, p.grid, p.rows, p.stages, p.row_groups)


def _fma(acc, x, w):
    """acc + x·w rounded once to float32, as fmaf."""
    return (acc.astype(np.float64) + np.float64(x) * w.astype(np.float64)).astype(np.float32)


def _sum_in_order(rows):
    s = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        s = s + r
    return s


def _meet(acc):
    """The row groups' sums met as the kernel meets them: with V = N·size/16
    column vectors a power of two of at least 8 (the groups then share each
    warp), by xor shuffles, s_g + s_{g^d} for d = 1, 2, 4, ...; else in group
    order from 0."""
    groups = acc.shape[0]
    vecs = fm.CONSUMERS // groups
    if vecs & (vecs - 1) == 0 and vecs >= 8:
        s = acc.copy()
        d = 1
        while d < groups:
            s = s + s[np.arange(groups) ^ d]
            d *= 2
        return s[0]
    return _sum_in_order(acc)


def emulate(p, x, W):
    """y by the bulk variant's arithmetic, in float32 and in its order:
    row group g of a block takes rows g, g + row_groups, ... of each unit
    (FMA chains carried over the block's units of one (member, tile)); the
    groups meet (``_meet``) into the segment's partial row; a tile's
    partial rows are added in block order from 0, and the tiles' sums into
    y in tile order from 0."""
    B, K, N = W.shape
    x, W = x.astype(np.float32), W.astype(np.float32)
    partials = np.zeros((p.segments, N), np.float32)
    for i in range(p.grid):
        seg, cur = int(p.block_segs[i]), None
        acc = np.zeros((p.row_groups, N), np.float32)
        for u in range(int(p.block_units[i]), int(p.block_units[i + 1])):
            b, t, k0, r = (int(v) for v in p.unit(u))
            if cur is not None and (b, t) != cur:
                partials[seg] = _meet(acc)
                seg += 1
                acc[:] = 0
            cur = (b, t)
            for j in range(r):
                acc[j % p.row_groups] = _fma(acc[j % p.row_groups], x[b, k0 + j], W[b, k0 + j])
        partials[seg] = _meet(acc)
    y = np.zeros((B, N), np.float32)
    for b in range(B):
        for t in range(p.tiles):
            s = b * p.tiles + t
            y[b] = y[b] + _sum_in_order(partials[p.tile_segs[s]:p.tile_segs[s + 1]])
    return y


def _inputs(B, K, N, dtype, seed):
    """x and W from numpy, as torch tensors of ``dtype`` and their float32
    values as numpy arrays."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(B, K).astype(np.float32)).to(TORCH_DTYPE[dtype])
    W = torch.from_numpy(rs.randn(B, K, N).astype(np.float32)).to(TORCH_DTYPE[dtype])
    return x, W, x.float().numpy(), W.float().numpy()


# (B, N, dtype, sm_count, kt as a function of R): tiles shorter, longer and
# equal to a unit; one row a tile; one tile past K; blocks fewer than
# members, members split across blocks
EMULATED = [
    (5, 200, "bfloat16", 7, lambda R: R + 1),
    (3, 512, "bfloat16", 3, lambda R: R - 1),
    (2, 512, "float32", 132, lambda R: 1),
    (1, 256, "float32", 3, lambda R: 7),
    (7, 200, "float32", 4, lambda R: R),
    (5, 512, "bfloat16", 132, lambda R: 1024),
]


@pytest.mark.parametrize("B,N,dtype,sm_count,kt_of", EMULATED)
def test_emulated_plan_matches_plain(B, N, dtype, sm_count, kt_of):
    """The emulation against ``fc_ktiled_plain`` within 1e-5·max|y|; the
    wrapper on CPU tensors is the plain version."""
    kt = kt_of(fm.plan(B, K, N, None, dtype, sm_count).rows)
    p = fm.plan(B, K, N, kt, dtype, sm_count)
    assert p.variant == "bulk"
    x, W, xn, Wn = _inputs(B, K, N, dtype, seed=B + N + kt)
    ref = fm.fc_ktiled_plain(x, W, kt).numpy()
    np.testing.assert_allclose(emulate(p, xn, Wn), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert torch.equal(fm.fc_ktiled(x, W, kt), torch.from_numpy(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_k8_is_k7_past_k(dtype):
    """K8's plan and K7's at kt ≥ K are the same plan, so the emulations
    agree bit for bit; both match ``fc_whole_plain``."""
    B, N, sm_count = 4, 200, 5
    x, W, xn, Wn = _inputs(B, K, N, dtype, seed=11)
    whole = emulate(fm.plan(B, K, N, None, dtype, sm_count), xn, Wn)
    for kt in (K, K + 1, 10 * K):
        assert np.array_equal(emulate(fm.plan(B, K, N, kt, dtype, sm_count), xn, Wn), whole)
    ref = fm.fc_whole_plain(x, W).numpy()
    np.testing.assert_allclose(whole, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kernel,kt_of", [("fc_ktiled", lambda R: R - 1), ("fc_ktiled", lambda R: 100),
                                          ("fc_whole", None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_plan_matches_pallas(interpret, kernel, kt_of, dtype):
    """The emulation against the JAX script's ``fc_ktiled`` (its tail tile
    zero-padded) and ``fc_whole``, run in interpret mode, within
    1e-5·max|y| (B = 3: interpret mode is slow)."""
    B, N, sm_count = 3, 512 if dtype == "bfloat16" else 256, 7
    _, _, xn, Wn = _inputs(B, K, N, dtype, seed=5)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jx, jW = jnp.asarray(xn).astype(jdt), jnp.asarray(Wn).astype(jdt)
    if kernel == "fc_whole":
        p, want = fm.plan(B, K, N, None, dtype, sm_count), np.asarray(exp_j.fc_whole(jx, jW))
    else:
        kt = kt_of(fm.plan(B, K, N, None, dtype, sm_count).rows)
        p, want = fm.plan(B, K, N, kt, dtype, sm_count), np.asarray(exp_j.fc_ktiled(jx, jW, kt))
    assert p.variant == "bulk" and p.grid < p.units  # blocks walk several units
    np.testing.assert_allclose(emulate(p, xn, Wn), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and no counter
    moves."""
    x, W, _, _ = _inputs(2, 16, 8, "float32", seed=1)
    before = (fm.fc_ktiled.launches, fm.fc_whole.launches, dict(fm.fc_ktiled.launches_by_variant),
              dict(fm.fc_whole.launches_by_variant), dict(fm.fc_ktiled.launches_by_kt))
    assert torch.equal(fm.fc_ktiled(x, W, 4), fm.fc_ktiled_plain(x, W, 4))
    assert torch.equal(fm.fc_whole(x, W), fm.fc_whole_plain(x, W))
    assert before == (fm.fc_ktiled.launches, fm.fc_whole.launches, dict(fm.fc_ktiled.launches_by_variant),
                      dict(fm.fc_whole.launches_by_variant), dict(fm.fc_ktiled.launches_by_kt))


def test_module_imports_no_jax():
    src = (ROOT / "deep_neuroevolution_torch" / "ops" / "fc_matvec.py").read_text()
    assert "jax" not in src and "deep_neuroevolution_tpu" not in src
