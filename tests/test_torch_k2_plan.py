"""K2's geometry (ops/noise_gradient.py ``plan`` and ``sorted_pairs``), on
the CPU.

The kernel runs only on a card, but the geometry it follows is mirrored in
Python: which outputs each block of the persistent grid sums and each of its
threads holds, and the order in which every block walks the pairs. These
tests check that every output is summed by one block and one thread, that
the threads read every element their tile needs and nothing at or past the
slice's end (so nothing at or past the table's), for adversarial offsets,
and, by a float32 emulation that sums in the kernel's order, that the
geometry computes g: against the plain version and the JAX package's XLA
path and Pallas kernel (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.ops import noise_gradient as k2
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops.pallas_kernels import GRANULE, gradient_from_noise_pallas


@pytest.mark.parametrize("sm_count", [132, 114, 3])
@pytest.mark.parametrize("D", [1, 3, 4, 5, 1000, 70_001, 1_004_852, 1_080_288, 1_080_289, 3_000_001])
def test_plan_covers_every_output_once(D, sm_count):
    """The tiles cut [0, D) with no gap or overlap; a block's threads'
    accumulators cover a tile; blocks take tiles round-robin, at most
    ``rounds`` each, and their counts differ by one at most."""
    p = k2.plan(300, D, sm_count)
    assert p.tile % 4 == 0 and 1 <= p.tile <= k2.TILE_MAX
    assert p.tile <= k2.THREADS * k2.PER  # the threads cover a tile
    cover = np.zeros(D, np.int32)
    counts = []
    for b in range(p.grid):
        tiles = p.block_tiles(b)
        assert 1 <= len(tiles) <= p.rounds
        counts.append(len(tiles))
        for t in tiles:
            lo, hi = p.tile_range(t)
            assert 0 <= lo < hi <= D
            cover[lo:hi] += 1
    assert (cover == 1).all()
    assert p.grid == min(sm_count, p.tiles) and max(counts) - min(counts) <= 1
    assert p.rounds == -(-p.tiles // p.grid)
    assert (p.rounds == 1) == (D <= sm_count * k2.TILE_MAX)  # one round while the blocks' tiles hold D


# adversarial offsets: (name, N, D, offsets)
def _offsets(name, N, D, B, rs):
    top = N - D
    if name == "ends":
        o = rs.choice([0, top], B)
    elif name == "odd":
        o = rs.randint(0, top // 2, B) * 2 + 1
    elif name == "equal":
        o = np.full(B, top // 3 | 1)
    elif name == "adjacent":
        o = (top // 2) + np.arange(B)
    else:  # "uniform", with the first and last valid offsets and an odd one
        o = rs.randint(0, top + 1, B)
        o[:3] = [0, top, 1]
    return np.clip(o, 0, top).astype(np.int32)


CASES = [  # (offsets, N, D, sm_count): D not a multiple of 4, D below a block's range, tiles past one
    # row of the threads (THREADS outputs) and within it, several rounds
    ("ends", 50_003, 12_003, 4),
    ("odd", 50_003, 9001, 8),
    ("ends", 50_003, 3001, 8),
    ("odd", 50_003, 3003, 8),
    ("equal", 50_003, 3002, 8),
    ("adjacent", 50_003, 3001, 8),
    ("uniform", 50_003, 3003, 8),
    ("uniform", 50_003, 20_001, 2),
    ("ends", 1001, 5, 8),
    ("ends", 1003, 3, 8),
    ("adjacent", 1002, 1, 8),
]


@pytest.mark.parametrize("name,N,D,sm_count", CASES)
def test_threads_cover_each_tile_and_stay_inside_the_slice(name, N, D, sm_count):
    """Every tile: its threads hold each of its outputs once, so each pair's
    loads read exactly table[idx + j] for the tile's outputs j, every one
    inside the slice [idx, idx + D) and so below N."""
    rs = np.random.RandomState(len(name) + D)
    idx = _offsets(name, N, D, 40, rs)
    p = k2.plan(len(idx), D, sm_count)
    for t in range(p.tiles):
        lo, hi = p.tile_range(t)
        outs = p.thread_outputs(t)
        held = outs[outs >= 0]
        assert np.array_equal(np.sort(held), np.arange(lo, hi))
        assert (outs[:, 0] >= 0).sum() == min(k2.THREADS, hi - lo)  # the first row: one output a thread
        reads = idx.astype(np.int64)[:, None] + held[None]
        assert (reads >= idx[:, None]).all() and (reads < idx[:, None].astype(np.int64) + D).all()
        assert (reads >= 0).all() and (reads < N).all()


def _emulate(table, idx, w, D, sm_count):
    """g as the kernel computes it: each thread's outputs of each tile
    summed in the blocks' pair order, one float32 FMA at a time."""
    p = k2.plan(len(idx), D, sm_count)
    order = k2.sorted_pairs(idx)
    g = np.full(D, np.nan, np.float32)
    for t in range(p.tiles):
        outs = p.thread_outputs(t)
        held = outs[outs >= 0]
        acc = np.zeros(held.size, np.float32)
        for i in order:
            x = table[idx[i] + held]
            acc = (acc.astype(np.float64) + np.float64(w[i]) * x.astype(np.float64)).astype(np.float32)
        g[held] = acc
    assert not np.isnan(g).any()
    return g


@pytest.mark.parametrize("name,N,D,sm_count", CASES)
def test_emulation_matches_plain_and_xla(name, N, D, sm_count):
    """The emulated kernel against the plain version and the JAX package's
    XLA path: float32 sums in another order, within 1e-5 of max|g|."""
    rs = np.random.RandomState(D)
    table = rs.randn(N).astype(np.float32)
    idx = _offsets(name, N, D, 40, rs)
    # all-equal offsets make g = (Σw)·table[o:o+D]: positive weights keep Σw
    # away from cancellation, which a tolerance relative to max|g| cannot take
    w = (rs.rand(40) if name == "equal" else rs.randn(40)).astype(np.float32)
    ours = _emulate(table, idx, w, D, sm_count)
    plain = k2.noise_gradient(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w), D).numpy()
    xla = np.asarray(jfit.gradient_from_noise(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), D, 16))
    tol = 1e-5 * np.abs(xla).max()
    np.testing.assert_allclose(ours, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=tol)


# the device envs' MLPs: the maze's ContinuousMLP (D=498, 256 pairs, a
# population of 512) and CartPole's SimpleClassifier (D=386, 2500 pairs),
# each D with each B
MLP_SHAPES = [(256, 498), (2500, 498), (256, 386), (2500, 386)]


@pytest.mark.parametrize("B,D", MLP_SHAPES)
def test_plan_and_emulation_at_the_mlp_widths(B, D):
    """On 132 SMs, one round of 4-output tiles (125 blocks for D=498, 97
    for D=386), every pair in one sort chunk; the emulated kernel, on
    uniform offsets, against the plain version and the JAX package's XLA
    path within 1e-5·max|g|."""
    p = k2.plan(B, D, 132)
    assert (p.tile, p.rounds, p.chunks) == (4, 1, 1)
    assert p.tiles == p.grid == {498: 125, 386: 97}[D]
    cover = np.zeros(D, np.int32)
    for t in range(p.tiles):
        outs = p.thread_outputs(t)
        cover[outs[outs >= 0]] += 1
    assert (cover == 1).all()
    rs = np.random.RandomState(B + D)
    N = 200_003
    table = rs.randn(N).astype(np.float32)
    idx = _offsets("uniform", N, D, B, rs)
    w = rs.randn(B).astype(np.float32)
    ours = _emulate(table, idx, w, D, 132)
    plain = k2.noise_gradient(torch.from_numpy(table), torch.from_numpy(idx), torch.from_numpy(w), D).numpy()
    xla = np.asarray(jfit.gradient_from_noise(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), D, 256))
    tol = 1e-5 * np.abs(xla).max()
    np.testing.assert_allclose(ours, plain, rtol=0, atol=tol)
    np.testing.assert_allclose(ours, xla, rtol=0, atol=tol)


def test_emulation_matches_pallas_on_aligned_offsets():
    """Where the TPU kernel takes the offsets (multiples of its granule),
    the emulated kernel against it in interpret mode."""
    rs = np.random.RandomState(3)
    N, D, B = 120_000, 5000, 23
    table = rs.randn(N).astype(np.float32)
    idx = (rs.randint(0, (N - 8 * 1024) // GRANULE, B) * GRANULE).astype(np.int32)
    w = rs.randn(B).astype(np.float32)
    pallas = np.asarray(gradient_from_noise_pallas(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(w), D, 2048,
                                                   True))
    np.testing.assert_allclose(_emulate(table, idx, w, D, 4), pallas, rtol=0, atol=1e-5 * np.abs(pallas).max())


def test_sorted_order_is_total_and_chunked():
    """Pairs in order of (offset, pair index) within chunks of SORT_CAP,
    the chunks in turn: ties keep their pair order, and a pair never leaves
    its chunk."""
    rs = np.random.RandomState(0)
    B = k2.SORT_CAP + 777
    idx = rs.randint(0, 50, B).astype(np.int32)  # many ties
    order = k2.sorted_pairs(idx)
    assert sorted(order.tolist()) == list(range(B))
    for c0 in range(0, B, k2.SORT_CAP):
        part = order[c0:c0 + k2.SORT_CAP]
        assert part.min() >= c0 and part.max() < c0 + k2.SORT_CAP
        keys = idx[part].astype(np.int64) << 32 | part
        assert (np.diff(keys) > 0).all()
    assert k2.plan(B, 100, 132).chunks == 2 and k2.plan(k2.SORT_CAP, 100, 132).chunks == 1
    assert k2.sorted_pairs(np.zeros(0, np.int32)).size == 0
