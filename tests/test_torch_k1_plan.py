"""K1's launch plan (ops/population_linear.py ``plan``), on the CPU.

The bulk variant's kernels run only on a card, but the plan they follow is
Python: which variant a shape takes, how the flattened (member, K-chunk)
units are split between the persistent blocks, and where each block's
partial rows go. These tests check that every (member, row of K) is summed
exactly once, that the blocks' loads differ by at most one unit, and, by a
float32 emulation that sums in the plan's order as the kernels do, that
the plan computes y: against the plain version and against the JAX
package's Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.ops import population_linear as pl
from deep_neuroevolution_tpu.ops.pallas_forward import population_linear as jax_population_linear

SIZE = {"float32": 4, "bfloat16": 2}


def _rows_of_units(p, units):
    """(member, first row, row count) of each unit index in ``units``."""
    b = units // p.chunks
    k0 = (units % p.chunks) * p.rows
    return b, k0, np.minimum(p.rows, p.K - k0)


def _check_bulk_plan(p):
    B, K, N, size = p.B, p.K, p.N, SIZE[p.dtype]
    bu, bs, ms = (a.astype(np.int64) for a in (p.block_units, p.block_segs, p.member_segs))
    assert p.grid == min(p.sm_count * pl.BLOCKS_PER_SM, p.units) and bu.shape == (p.grid + 1,)
    assert bu[0] == 0 and bu[-1] == p.units and p.chunks == -(-K // p.rows)
    loads = np.diff(bu)
    assert loads.min() >= 1 and loads.max() - loads.min() <= 1  # balanced to one unit
    # every (member, row) covered exactly once
    cover = np.zeros((B, K), np.int32)
    b, k0, r = _rows_of_units(p, np.arange(p.units))
    assert (r >= 1).all()
    np.add.at(cover, (np.repeat(b, r), np.repeat(k0, r) + np.arange(r.sum()) - np.repeat(np.cumsum(r) - r, r)), 1)
    assert (cover == 1).all()
    # bulk copies: 16-byte sizes and offsets, x's slice included
    assert (p.rows * size) % 16 == 0 and (N * size) % 16 == 0 and (K * size) % 16 == 0
    # the segment maps: block i's partial rows follow its members in order,
    # and member b's rows are the blocks that touch b, in block order
    first, last = bu[:-1] // p.chunks, (bu[1:] - 1) // p.chunks
    assert (np.diff(bs) == last - first + 1).all() and bs[0] == 0
    seg_member = np.concatenate([np.arange(f, l + 1) for f, l in zip(first, last)])
    assert len(seg_member) == p.segments == bs[-1] == ms[-1]
    assert (np.diff(seg_member) >= 0).all()
    assert (np.bincount(seg_member, minlength=B) == np.diff(ms)).all()
    # shared memory: the plan's blocks fit an H100 SM's 233,472 bytes, with
    # the 1 KB the card reserves for each, and the ring keeps ≥ 48 KB in
    # flight per SM
    assert p.stages >= 2 and p.smem_bytes == pl.smem_bytes(p.rows, N, size, p.stages)
    assert pl.BLOCKS_PER_SM * (p.smem_bytes + 1024) <= 233_472
    ring = p.stages * p.rows * N * size
    assert pl.BLOCKS_PER_SM * ring >= 48 * 1024 or p.rows == K
    vecs = N * size // 16
    assert vecs <= pl.CONSUMERS and p.row_groups == pl.CONSUMERS // vecs


def _bulk_ok(K, N, dtype):
    size = SIZE[dtype]
    return K > 0 and (N * size) % 16 == 0 and (K * size) % 16 == 0


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4, 5, 128, 256])
def test_plan_covers_every_row_once(B, dtype, sm_count):
    """Every (b, k) row is summed once, the blocks' loads differ by at most
    one unit, and what the bulk copies cannot take goes to 'general'."""
    for K in (0, 7, 100, 3872, 7744):
        for N in (1, 30, 256, 512):
            p = pl.plan(B, K, N, dtype, sm_count)
            if _bulk_ok(K, N, dtype):
                assert p.variant == "bulk", (K, N, p.reason)
                _check_bulk_plan(p)
            else:
                assert p.variant == "general" and p.reason, (K, N)
                assert p.block_units is None and p.segments == 0


def test_unaligned_pointers_take_general():
    assert pl.plan(128, 3872, 256, "float32", 132, aligned=True).variant == "bulk"
    p = pl.plan(128, 3872, 256, "float32", 132, aligned=False)
    assert p.variant == "general" and "aligned" in p.reason


def test_main_path_shapes_take_bulk():
    """The ES, RS and GA fc shapes, the ES eval episodes' B=4 and bf16."""
    for B, K, N, dtype in [(128, 3872, 256, "float32"), (256, 3872, 256, "float32"), (256, 3872, 256, "bfloat16"),
                           (128, 7744, 512, "float32"), (4, 3872, 256, "float32")]:
        p = pl.plan(B, K, N, dtype, 132)
        assert p.variant == "bulk" and p.grid == 132 * pl.BLOCKS_PER_SM, (B, K, N, dtype)
        assert p.rows * N * SIZE[dtype] == pl.UNIT_BYTES  # 32 KB units


def test_wide_rows_take_general():
    """A consumer thread owns one 16-byte column vector: N up to 1024 float32
    or 2048 bfloat16 values takes the bulk variant, wider rows the general."""
    assert pl.plan(2, 16, 1024, "float32", 132).variant == "bulk"
    assert pl.plan(2, 16, 2048, "bfloat16", 132).variant == "bulk"
    for N, dtype in ((1028, "float32"), (2056, "bfloat16")):
        p = pl.plan(2, 16, N, dtype, 132)
        assert p.variant == "general" and "columns" in p.reason


def emulate(p, x, W):
    """y by the bulk variant's arithmetic, in float32 and in its order:
    each row group of a block sums its rows of each unit in row order, the
    groups meet in order into one partial row per (block, member), and the
    second pass's 8 warps sum a member's rows w, w + 8, ... before warp 0
    sums the warps in order."""
    B, K, N = W.shape
    x, W = x.astype(np.float32), W.astype(np.float32)
    partials = np.zeros((p.segments, N), np.float32)
    for i in range(p.grid):
        seg = int(p.block_segs[i])
        acc = np.zeros((p.row_groups, N), np.float32)
        member = int(p.block_units[i]) // p.chunks
        for u in range(int(p.block_units[i]), int(p.block_units[i + 1])):
            b, k0, r = (int(v) for v in _rows_of_units(p, np.int64(u)))
            if b != member:
                partials[seg] = _sum_in_order(acc)
                seg, member = seg + 1, b
                acc[:] = 0
            for j in range(r):
                g = j % p.row_groups
                acc[g] = acc[g] + x[b, k0 + j] * W[b, k0 + j]
        partials[seg] = _sum_in_order(acc)
    y = np.zeros((B, N), np.float32)
    for b in range(B):
        s0, s1 = int(p.member_segs[b]), int(p.member_segs[b + 1])
        lanes = [_sum_in_order(partials[s0 + w : s1 : 8]) for w in range(8)]
        y[b] = _sum_in_order(np.stack(lanes))
    return y


def _sum_in_order(rows):
    s = np.zeros(rows.shape[1:], np.float32)
    for r in rows:
        s = s + r
    return s


def _inputs(B, K, N, seed):
    rs = np.random.RandomState(seed)
    return rs.rand(B, K).astype(np.float32), rs.randn(B, K, N).astype(np.float32)


@pytest.mark.parametrize(
    "B,K,N,sm_count",
    [
        (5, 100, 256, 132),  # fewer units than blocks: one unit a block, each member split 3 ways
        (4, 3872, 256, 132),  # the ES eval episodes' shape: 3-4 units a block
        (7, 400, 64, 3),  # six blocks across seven members: partials at both ends of a range
        (3, 200, 24, 2),  # N = 24: 6 vectors a row, 42 row groups
        (2, 64, 1000, 1),  # N = 1000: 250 vectors, one row group, six consumers idle
    ],
)
def test_emulated_plan_matches_plain(B, K, N, sm_count):
    """float32 sums in the plan's order against the plain version: within
    1e-5 of max|y|, as the card is held."""
    p = pl.plan(B, K, N, "float32", sm_count)
    assert p.variant == "bulk"
    x, W = _inputs(B, K, N, seed=B + K)
    ref = pl.population_linear_plain(torch.from_numpy(x), torch.from_numpy(W)).numpy()
    y = emulate(p, x, W)
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("shape,sm_count", [((3, 400, 64), 2), ((2, 1200, 24), 3)])
def test_emulated_plan_matches_pallas(shape, sm_count):
    """The same against the JAX package's Pallas kernel in interpret mode
    (B small: interpret mode is slow)."""
    x, W = _inputs(*shape, seed=7)
    p = pl.plan(*shape, "float32", sm_count)
    assert p.variant == "bulk" and p.segments > shape[0]  # members are split between blocks
    pallas = np.asarray(jax_population_linear(jnp.asarray(x), jnp.asarray(W), interpret=True))
    np.testing.assert_allclose(emulate(p, x, W), pallas, rtol=1e-5, atol=1e-5)


def test_emulated_plan_bf16_inputs():
    """bf16 x and W: the products are exact in float32, so the emulation
    on the bf16 values matches the plain version within 1e-5·max|y|."""
    x, W = _inputs(6, 128, 256, seed=3)
    xb, Wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(W).bfloat16()
    p = pl.plan(6, 128, 256, "bfloat16", 4)
    assert p.variant == "bulk" and p.row_groups == 8
    ref = pl.population_linear_plain(xb, Wb).numpy()
    y = emulate(p, xb.float().numpy(), Wb.float().numpy())
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_cpu_tensors_launch_nothing():
    """On a CPU tensor the wrapper runs the plain version and no counter moves."""
    x, W = (torch.from_numpy(a) for a in _inputs(2, 16, 8, seed=1))
    counts = (pl.population_linear.launches, pl.population_linear.bulk_launches,
              pl.population_linear.general_launches)
    pl.population_linear(x, W)
    assert counts == (pl.population_linear.launches, pl.population_linear.bulk_launches,
                      pl.population_linear.general_launches)
