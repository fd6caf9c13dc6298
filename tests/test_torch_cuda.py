"""The port's CUDA kernels and its main path on a card, against the plain
PyTorch versions. Every test here needs a CUDA device, nvcc and g++, and
skips without them. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import MIDPOINT, campaign_script, recording_theta_override, vbn_all_ties_case, vbn_random_ops
from chip_smoke import sequential as _sequential
from deep_neuroevolution_torch.algos import es
from deep_neuroevolution_torch.algos import ga
from deep_neuroevolution_torch.algos.rollout_host import collect_ref_batch_host
from deep_neuroevolution_torch.envs.atari import AtariEnv
from deep_neuroevolution_torch.models import LargeDQN, SmallDQN, VirtualBNDQN
from deep_neuroevolution_torch.models.core import extract_patches
from deep_neuroevolution_torch.ops import fc_matvec
from deep_neuroevolution_torch.ops import fused_dqn as fk
from deep_neuroevolution_torch.ops import optim
from deep_neuroevolution_torch.ops.noise import NoiseTable
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain
from deep_neuroevolution_torch.ops.population_linear import population_linear, population_linear_plain
from deep_neuroevolution_torch.utils import tabular

pytestmark = pytest.mark.cuda

exp_large_fwd = campaign_script("exp_large_fwd_torch")  # K7's and K8's wrappers, K3's race modes


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(B, K, N, device, dtype, offset=0):
    g = torch.Generator().manual_seed(B * 1000 + K + N)
    x = torch.rand(B, K, generator=g)
    W = torch.randn(B, K, N, generator=g)
    # ``offset`` elements in front of W shift its address off 16-byte alignment
    Wbuf = torch.empty(offset + W.numel(), dtype=dtype, device=device)
    Wd = Wbuf[offset:].view(B, K, N)
    Wd.copy_(W.to(device, dtype))
    return x.to(device, dtype), Wd


# (shape, offset, variant): the aligned main-path shapes take the bulk
# variant; W off 16-byte alignment (offset=1), rows that are not a multiple
# of 16 bytes (N=30, N=1) and K=0 take the general one
K1_CASES = [
    ((128, 3872, 256), 0, "bulk"),
    ((4, 3872, 256), 0, "bulk"),
    ((128, 7744, 512), 0, "bulk"),
    ((5, 3872, 256), 1, "general"),
    ((3, 100, 30), 0, "general"),
    ((2, 7, 1), 0, "general"),
    ((3, 0, 8), 0, "general"),
    ((1, 3872, 256), 0, "bulk"),
    ((7, 3872, 256), 0, "bulk"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,variant", K1_CASES)
def test_population_linear_matches_plain(cuda_device, shape, offset, variant, dtype):
    """f32 sums in another order: within 1e-5 of max|y|. The variant's
    counter moves, and only its own."""
    x, W = _k1_inputs(*shape, cuda_device, dtype, offset)
    before = {v: getattr(population_linear, f"{v}_launches") for v in ("bulk", "general")}
    launches = population_linear.launches
    y = population_linear(x, W)
    ref = population_linear_plain(x, W)
    torch.cuda.synchronize()
    assert population_linear.launches == launches + 1
    other = "general" if variant == "bulk" else "bulk"
    assert getattr(population_linear, f"{variant}_launches") == before[variant] + 1
    assert getattr(population_linear, f"{other}_launches") == before[other]
    assert y.dtype == torch.float32 and y.shape == (shape[0], shape[2])
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset,variant", [K1_CASES[i] for i in (0, 1, 3, 7, 8)])
def test_population_linear_repeats_bit_for_bit(cuda_device, shape, offset, variant, dtype):
    """No float atomics: launches on the same inputs give the same y. At
    B = 1, 4 and 7 a ring stage is refilled while few blocks hold it, where
    a release without the proxy fence showed (K3, csrc/bulk_ring.cuh), so
    those repeat ten times."""
    x, W = _k1_inputs(*shape, cuda_device, dtype, offset)
    first = population_linear(x, W)
    ys = [population_linear(x, W) for _ in range(10 if shape[0] < 8 else 1)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in ys)


@pytest.mark.parametrize("B", [0, 1, 300, 1000])
def test_noise_gradient_matches_plain(cuda_device, B):
    """Unaligned offsets, one slice ending at the last element; f32 sums in
    another order: within 1e-5 of max|g|."""
    gen = torch.Generator().manual_seed(B)
    N, dim = 200_000, 70_001
    table = torch.randn(N, generator=gen).to(cuda_device)
    idxs = torch.randint(0, N - dim + 1, (B,), generator=gen, dtype=torch.int32)
    if B:
        idxs[0] = N - dim
    w = torch.randn(B, generator=gen)
    idxs, w = idxs.to(cuda_device), w.to(cuda_device)
    g = noise_gradient(table, idxs, w, dim)
    ref = noise_gradient_plain(table, idxs, w, dim)
    torch.cuda.synchronize()
    torch.testing.assert_close(g, ref, rtol=0, atol=1e-5 * max(1.0, float(ref.abs().max())))


def test_noise_gradient_at_the_humanoid_shape(cuda_device):
    """K2 at the vector-engine path's shape: 500 pairs (a humanoid.json
    generation's 1000 episodes) × D = 159,505 (the Humanoid-v5 MLP), on
    the reference table's first 25M floats: within 1e-5 of max|g|."""
    table = NoiseTable.from_seed(count=25_000_000, device=cuda_device).noise
    gen = torch.Generator().manual_seed(159_505)
    B, dim = 500, 159_505
    idxs = torch.randint(0, table.numel() - dim + 1, (B,), generator=gen, dtype=torch.int32).to(cuda_device)
    w = torch.randn(B, generator=gen).to(cuda_device)
    launches = noise_gradient.launches
    g = noise_gradient(table, idxs, w, dim)
    ref = noise_gradient_plain(table, idxs, w, dim)
    torch.cuda.synchronize()
    assert noise_gradient.launches == launches + 1
    torch.testing.assert_close(g, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def _k2_offsets(name, N, D, B, gen):
    """Offsets of one adversarial kind, each in [0, N - D]."""
    top = N - D
    if name == "ends":  # the first and the last valid offset
        o = torch.randint(0, 2, (B,), generator=gen) * top
    elif name == "odd":
        o = torch.randint(0, top // 2, (B,), generator=gen) * 2 + 1
    elif name == "equal":
        o = torch.full((B,), top // 3 | 1)
    elif name == "adjacent":
        o = top // 2 + torch.arange(B)
    else:
        o = torch.randint(0, top + 1, (B,), generator=gen)
        o[:3] = torch.tensor([0, top, 1])
    return o.clamp(0, top).to(torch.int32)


# (offsets, N, D, B): D not a multiple of 4, D below a block's range of
# outputs, D of two rounds of tiles (132 · 8184 < D), B above the sort
# capacity (8192), B = 2500 at the ES model's D
K2_CASES = [
    ("ends", 200_003, 70_001, 300),
    ("odd", 200_003, 70_003, 300),
    ("equal", 200_003, 70_002, 300),
    ("adjacent", 200_003, 70_001, 300),
    ("uniform", 200_003, 70_003, 2500),
    ("ends", 1001, 5, 64),
    ("ends", 1003, 3, 64),
    ("adjacent", 1002, 1, 64),
    ("uniform", 1_300_001, 1_200_001, 64),
    ("uniform", 400_001, 20_001, 8192 + 777),
    ("uniform", 4_000_000, 1_004_852, 2500),
]


@pytest.mark.parametrize("name,N,D,B", K2_CASES)
def test_noise_gradient_adversarial_offsets(cuda_device, name, N, D, B):
    """The kernel against its plain version on each kind of offset: float32
    sums in the sorted order, within 1e-5 of max|g|. All-equal offsets make
    g = (Σw)·slice, so their weights are positive (no cancellation in Σw)."""
    gen = torch.Generator().manual_seed(N + D + B)
    table = torch.randn(N, generator=gen).to(cuda_device)
    idxs = _k2_offsets(name, N, D, B, gen).to(cuda_device)
    w = (torch.rand(B, generator=gen) if name == "equal" else torch.randn(B, generator=gen)).to(cuda_device)
    launches = noise_gradient.launches
    g = noise_gradient(table, idxs, w, D)
    ref = noise_gradient_plain(table, idxs, w, D)
    torch.cuda.synchronize()
    assert noise_gradient.launches == launches + 1
    tol = 1e-5 * float(ref.abs().max())
    print(f"K2 {name} N={N} D={D} B={B}: max abs err {float((g - ref).abs().max()):.3g} (tol {tol:.3g})")
    torch.testing.assert_close(g, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("case", [K2_CASES[i] for i in (4, 5, 9, 10)])
def test_noise_gradient_repeats_bit_for_bit(cuda_device, case):
    """A fixed sum order and no atomics: launches on the same inputs give
    the same g, ties among offsets included."""
    name, N, D, B = case
    gen = torch.Generator().manual_seed(B)
    table = torch.randn(N, generator=gen).to(cuda_device)
    idxs = _k2_offsets(name, N, D, B, gen)
    idxs[B // 2:] = idxs[:B - B // 2].clone()  # every offset twice
    idxs, w = idxs.to(cuda_device), torch.randn(B, generator=gen).to(cuda_device)
    first = noise_gradient(table, idxs, w, D)
    assert all(torch.equal(first, noise_gradient(table, idxs, w, D)) for _ in range(5))


def test_noise_gradient_takes_a_misaligned_table(cuda_device):
    """The loads are scalar: a view of the table that starts off a 16-byte
    boundary launches the kernel and gives the plain version's g."""
    table = torch.randn(10_001, device=cuda_device)
    idxs = torch.tensor([0, 7, 8_999], dtype=torch.int32, device=cuda_device)  # 8999 + 999: the last view's end
    w = torch.tensor([1.0, -2.0, 0.5], device=cuda_device)
    for start in (1, 2, 3):
        view = table[start:]
        launches = noise_gradient.launches
        g = noise_gradient(view, idxs, w, 999)
        torch.cuda.synchronize()
        assert noise_gradient.launches == launches + 1
        ref = noise_gradient_plain(view, idxs, w, 999)
        torch.testing.assert_close(g, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_noise_gradient_geometry_matches_the_plan(cuda_device):
    """ops/noise_gradient.py's ``plan`` and constants (which the CPU tests
    check) are the geometry the C entry point launches."""
    import ctypes

    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import noise_gradient as k2

    lib = _cuda_build.load()
    out = (ctypes.c_longlong * 8)()
    for D in (1, 5, 1000, 70_001, 1_004_852, 1_200_001, 3_000_001):
        for sms in (132, 114, 3):
            lib.nevo_noise_gradient_geometry(D, sms, out)
            p = k2.plan(1, D, sms)
            want = [p.tile, p.tiles, p.grid, p.rounds, k2.SORT_CAP, k2.TILE_MAX, k2.THREADS, k2.PER]
            assert list(out) == want, (D, sms)


def test_vbn_forward_card_matches_cpu(cuda_device):
    """The population forward with K1 against the CPU's plain forward, from
    the same θ: float32, within 1e-3 of max|score|; equal argmax away from
    near ties."""
    model = VirtualBNDQN(num_actions=4)
    gen = torch.Generator().manual_seed(0)
    base = model.init_theta(gen)
    thetas = base[None] + 0.02 * torch.randn(6, model.num_params, generator=gen)
    ref = torch.rand(16, 84, 84, 4, generator=gen)
    obs = torch.rand(6, 84, 84, 4, generator=gen)
    scores = []
    for dev in (cuda_device, torch.device("cpu")):
        th = thetas.to(dev)
        stats = model.batch_ref_stats(th, ref.to(dev))
        parts, _ = model.prepare_batch_params((th, stats))
        scores.append(model.batch_scores_parts(parts, obs.to(dev), stats).cpu())
    card, cpu = scores
    tol = 1e-3 * max(1.0, float(cpu.abs().max()))
    torch.testing.assert_close(card, cpu, rtol=0, atol=tol)
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert torch.equal(card.argmax(-1)[clear], cpu.argmax(-1)[clear])


def test_es_generation_on_card(cuda_device, monkeypatch):
    """A small generation at full width on the card: both kernels launch,
    K1 on its bulk variant only, and θ' is finite."""
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    env = AtariEnv("toy", batch_size=8, num_threads=2)
    model = VirtualBNDQN(num_actions=env.num_actions)
    tr = es.ESTrainer(env, model, es.ESConfig(population_size=16, episode_cutoff_mode=15),
                      optimizer=optim.Adam(0.01), noise_table=NoiseTable.from_seed(count=2_000_000),
                      device=cuda_device)
    k1, k2 = population_linear.launches, noise_gradient.launches
    bulk, general = population_linear.bulk_launches, population_linear.general_launches
    stats = tr.train_step()
    tr.close()
    assert population_linear.launches > k1 and noise_gradient.launches == k2 + 1
    assert population_linear.bulk_launches - bulk == population_linear.launches - k1
    assert population_linear.general_launches == general
    assert stats.returns.shape == (8, 2) and np.isfinite(stats.update_ratio)
    assert bool(torch.isfinite(tr.theta).all()) and tr.theta.device.type == "cuda"


def _genomes(model, B, seed, device):
    """B first-generation genomes θ = ε·scale_by, drawn on the CPU."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, model.num_params, generator=g) * model.scale_by()).to(device)


def _frames(B, seed, device):
    return torch.rand(B, 84, 84, 4, generator=torch.Generator().manual_seed(seed + 1)).to(device)


def _k3_ops(B, num_actions, device):
    model = LargeDQN(num_actions=num_actions, forward_impl="fused")
    parts, _ = model.prepare_batch_params((_genomes(model, B, B, device), None))
    obs = _frames(B, B, device)
    return dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))


@pytest.mark.parametrize("num_actions", [4, 18])
@pytest.mark.parametrize("B", [1, 7, 128, 256])
def test_large_dqn_fused_matches_plain(cuda_device, B, num_actions):
    """K3 against its plain version on the card: within 1e-3·max|score|
    (both keep the bf16 roundings of x1 and x2 and sum in f32 in other
    orders, so a rounding can flip one ulp; dropping the roundings moves
    the scores by 2e-3·max or more, while the kernel's chunked tensor-core
    order stays inside, TestCardTolerance in test_torch_dqn.py), equal
    argmax away from near ties, padded lanes at −1e9."""
    ops = _k3_ops(B, num_actions, cuda_device)
    before = fk.large_dqn_fused_scores.launches
    before_b = fk.large_dqn_fused_scores.launches_by_batch.get(B, 0)
    y = fk.large_dqn_fused_scores(ops)
    ref = fk.large_dqn_fused_scores_plain(ops)
    torch.cuda.synchronize()
    assert fk.large_dqn_fused_scores.launches == before + 1
    assert fk.large_dqn_fused_scores.launches_by_batch[B] == before_b + 1
    assert y.shape == (B, 64) and y.dtype == torch.float32
    tol = 1e-3 * float(ref[:, :num_actions].abs().max())
    err = float((y[:, :num_actions] - ref[:, :num_actions]).abs().max())
    print(f"K3 B={B} A={num_actions}: max abs err {err} (tol {tol})")  # shown with pytest -s
    torch.testing.assert_close(y[:, :num_actions], ref[:, :num_actions], rtol=0, atol=tol)
    assert bool((y[:, num_actions:] < -1e8).all())
    top2 = ref[:, :num_actions].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(y.argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("B", [1, 128])
def test_large_dqn_fused_repeats_bit_for_bit(cuda_device, B):
    """Every sum of K3 runs in a fixed order: two launches on the same
    inputs give the same scores, bit for bit."""
    ops = _k3_ops(B, 4, cuda_device)
    y1 = fk.large_dqn_fused_scores(ops)
    y2 = fk.large_dqn_fused_scores(ops)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


def _k5_args(cls, dtype, B, device):
    kw = {"forward_impl": "split"} if cls is LargeDQN else {}
    model = cls(num_actions=4, compute_dtype=dtype, conv_impl="fused", **kw)
    parts, _ = model.prepare_batch_params((_genomes(model, B, B, device), None))
    return model, model.conv_chain_args(parts, _frames(B, B, device))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls", [SmallDQN, LargeDQN])
@pytest.mark.parametrize("B", [1, 5, 7, 128, 256])
def test_conv_chain_matches_plain(cuda_device, B, cls, dtype):
    """K5 against its plain version on the card: float32 within 1e-5·max|x|
    (sums in another order), bfloat16 within 1e-3·max|x| (the roundings of
    the intermediates kept, as at K3; the tensor cores' order stays inside,
    TestCardTolerance in test_torch_dqn.py). B = 128 and 256 give the
    persistent grid one and two members a block, 1 and 7 few blocks."""
    model, args = _k5_args(cls, dtype, B, cuda_device)
    before = fk.dqn_conv_chain_fused.launches
    before_b = fk.dqn_conv_chain_fused.launches_by_batch.get(B, 0)
    y = fk.dqn_conv_chain_fused(*args)
    ref = fk.dqn_conv_chain_plain(*args)
    torch.cuda.synchronize()
    assert fk.dqn_conv_chain_fused.launches == before + 1
    assert fk.dqn_conv_chain_fused.launches_by_batch[B] == before_b + 1
    assert y.shape == (B, 121, model.LAYERS[-1][1]) and y.dtype == torch.float32
    tol = (1e-5 if dtype == "float32" else 1e-3) * float(ref.abs().max())
    print(f"K5 {cls.__name__} {dtype} B={B}: max abs err {float((y - ref).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls", [SmallDQN, LargeDQN])
@pytest.mark.parametrize("B", [1, 7, 256])
def test_conv_chain_repeats_bit_for_bit(cuda_device, B, cls, dtype):
    """Every sum of K5 runs in a fixed order: ten launches on the same
    inputs give the same activations, bit for bit (at B = 1 and 7 a stage
    is refilled while the block still works on its member)."""
    _, args = _k5_args(cls, dtype, B, cuda_device)
    first = fk.dqn_conv_chain_fused(*args)
    ys = [fk.dqn_conv_chain_fused(*args) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in ys)


@pytest.mark.parametrize("seed", range(100, 112))
def test_conv_chain_large_bf16_over_seeds(cuda_device, seed):
    """bf16 LargeDQN K5 against its plain version at B = 64 within
    1e-3·max|x|, over the twelve seeds (genomes and frames drawn on the
    card) on which the tensor cores' order alone read up to 1.21 of the
    limit, one x1 rounding flipping more of x2, before the near ties were
    recomputed as sequential chains."""
    B = 64
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    model = LargeDQN(num_actions=4, compute_dtype="bfloat16", conv_impl="fused", forward_impl="split")
    th = torch.randn((B, model.num_params), generator=gen, device=cuda_device) * model.scale_by(
        model.scale_style, cuda_device)
    parts, _ = model.prepare_batch_params((th, None))
    args = model.conv_chain_args(parts, torch.rand((B, 84, 84, 4), generator=gen, device=cuda_device))
    y = fk.dqn_conv_chain_fused(*args)
    ref = fk.dqn_conv_chain_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-3 * float(ref.abs().max())
    print(f"K5 LargeDQN bfloat16 B={B} seed {seed}: max abs err {float((y - ref).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls", [SmallDQN, LargeDQN])
def test_conv_chain_on_engine_frames(cuda_device, cls, dtype):
    """K5 on frames from the ToyCatch engine (mostly blank, so patches and
    their near ties repeat) and GA children (first-generation genomes plus
    one 0.002 mutation, so the biases are not 0), B = 128: against its
    plain version within 1e-5·max|x| (float32) or 1e-3·max|x| (bfloat16),
    and a second launch bit for bit."""
    B = 128
    env = AtariEnv("toy", batch_size=16, num_threads=2)
    try:
        frames = collect_ref_batch_host(env, 9, cuda_device, batch_size=B)
    finally:
        env.close()
    kw = {"forward_impl": "split"} if cls is LargeDQN else {}
    model = cls(num_actions=4, compute_dtype=dtype, conv_impl="fused", **kw)
    th = _genomes(model, B, 9, cuda_device)
    th = th + 0.002 * torch.randn(th.shape, generator=torch.Generator().manual_seed(10)).to(cuda_device)
    parts, _ = model.prepare_batch_params((th, None))
    args = model.conv_chain_args(parts, frames)
    y = fk.dqn_conv_chain_fused(*args)
    ref = fk.dqn_conv_chain_plain(*args)
    again = fk.dqn_conv_chain_fused(*args)
    torch.cuda.synchronize()
    tol = (1e-5 if dtype == "float32" else 1e-3) * float(ref.abs().max())
    print(f"K5 {cls.__name__} {dtype} engine frames B={B}: max abs err {float((y - ref).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)
    assert torch.equal(y, again)


def k5_all_ties_case(cls, B, device):
    """bf16 K5 operands on which every value of x1, and every value of the
    LargeDQN's x2 clear of the padding, lies within a few float32 ulps of a
    bf16 rounding midpoint, so each conv notes thousands of near ties, more
    than K5's list holds (512): every patch row of a member is its frame's
    centre patch, so a channel's sum repeats at all 441 positions (x2's at
    the 81 positions whose taps all lie inside x1), and each bias puts that
    sum on MIDPOINT. Returns the args and the output the sequential chains
    give, which K5 must match once it recomputes every value of the conv."""
    _, args = _k5_args(cls, "bfloat16", B, device)
    row = args[0][:, 220:221]  # the centre patch, (10, 10)
    p1, w1, w2 = row.expand(-1, 441, -1).contiguous(), args[1].float(), args[3].float()
    b1 = (MIDPOINT - _sequential(row.float(), w1).double()).float()
    x1 = torch.relu(_sequential(p1.float(), w1) + b1).to(torch.bfloat16).float()
    x1p = extract_patches(x1.reshape(B, 21, 21, -1), 4, 2).reshape(B, 121, -1)
    if cls is SmallDQN:
        return [p1, args[1], b1, args[3], args[4]], torch.relu(torch.bmm(x1p, w2) + args[4])
    b2 = (MIDPOINT - _sequential(x1p[:, 60:61], w2).double()).float()  # (5, 5): every tap inside x1
    x2 = torch.relu(_sequential(x1p, w2) + b2).to(torch.bfloat16).float()
    x2p = extract_patches(x2.reshape(B, 11, 11, -1), 3, 1).reshape(B, 121, -1)
    out = torch.relu(torch.bmm(x2p, args[5].float()) + args[6])
    return [p1, args[1], b1, args[3], b2, args[5], args[6]], out


@pytest.mark.parametrize("cls", [SmallDQN, LargeDQN])
def test_conv_chain_recomputes_every_value_past_the_tie_list(cuda_device, cls):
    """When a conv notes more near ties than K5's list holds, K5 recomputes
    every value of that conv as the sequential chain: on k5_all_ties_case
    (tests/test_torch_dqn.py checks on the CPU that the tensor cores' order
    rounds far more than 512 of its values apart from the chain) the output
    matches the chains' within 1e-5·max|x|, the float32 limit; a value left
    with the tensor cores' rounding moves it by about 1e-3·max."""
    args, want = k5_all_ties_case(cls, 3, cuda_device)
    y = fk.dqn_conv_chain_fused(*args)
    torch.cuda.synchronize()
    tol = 1e-5 * float(want.abs().max())
    print(f"K5 {cls.__name__} bfloat16 all ties: max abs err {float((y - want).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, want, rtol=0, atol=tol)


def test_fused_wrappers_reject_misaligned_inputs(cuda_device):
    """The kernels read 16-byte vectors: a misaligned operand raises."""
    model = LargeDQN(num_actions=4, forward_impl="fused")
    parts, _ = model.prepare_batch_params((_genomes(model, 1, 0, cuda_device), None))
    ops = dict(parts["__fused_lg__"], patches1=torch.zeros(1, 441, 256, dtype=torch.bfloat16, device=cuda_device))
    buf = torch.zeros(ops["wf"].numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fk.large_dqn_fused_scores(dict(ops, wf=buf[1:].view(ops["wf"].shape)))


K3_MODES = sorted(set(exp_large_fwd.FUSED_MODES.values()))  # ('fma', 'ksplit'), ('fma', 'scratch'), ('mxu_t', 'ksplit')


@pytest.mark.parametrize("modes", [m for m in K3_MODES if m != ("fma", "scratch")])
@pytest.mark.parametrize("seed", range(100, 106))
def test_large_dqn_fused_modes_over_seeds(cuda_device, seed, modes):
    """K3's other modes against their plain versions at B = 64, 18 actions,
    genomes and frames drawn on the card: within 1e-3·max|score|, as the
    default pair. 'mxu_t' runs the kernel's variant that rounds x3 to bf16
    (its own entry of ``launches_by_mode`` moves), where the card's x3 and
    the plain version's can round apart at a midpoint; 'mxu_t' must also
    lie nearer its plain version than that lies from the plain 'fma': on
    average over the scores, within a quarter of that distance (a kernel
    that dropped or moved the rounding reads about 1). 'ksplit' runs the
    'scratch' code, which differs from the tap-by-tap sums only in their
    order. A second launch repeats the first bit for bit."""
    B, na = 64, 18
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    model = LargeDQN(num_actions=na, forward_impl="fused")
    th = torch.randn((B, model.num_params), generator=gen, device=cuda_device) * model.scale_by(
        model.scale_style, cuda_device)
    parts, _ = model.prepare_batch_params((th, None))
    obs = torch.rand((B, 84, 84, 4), generator=gen, device=cuda_device)
    ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
    by_mode = fk.large_dqn_fused_scores.launches_by_mode
    mode = "/".join(modes)
    before = by_mode.get(mode, 0)
    y = fk.large_dqn_fused_scores(ops, *modes)
    ref = fk.large_dqn_fused_scores_plain(ops, *modes)
    again = fk.large_dqn_fused_scores(ops, *modes)
    torch.cuda.synchronize()
    assert by_mode[mode] == before + 2
    tol = 1e-3 * float(ref[:, :na].abs().max())
    err = float((y[:, :na] - ref[:, :na]).abs().max())
    print(f"K3 {mode} B={B} seed {seed}: max abs err {err} ({err / tol * 1e-3:.3g}·max)")
    torch.testing.assert_close(y[:, :na], ref[:, :na], rtol=0, atol=tol)
    assert torch.equal(y, again)
    if modes[0] == "mxu_t":
        fma = fk.large_dqn_fused_scores_plain(ops, "fma", modes[1])[:, :na]
        sep = float((y[:, :na] - ref[:, :na]).abs().mean() / (fma - ref[:, :na]).abs().mean())
        print(f"K3 {mode} B={B} seed {seed}: mean |card − plain| / mean |plain fma − plain| {sep:.3g}")
        assert sep < 0.25


@pytest.mark.parametrize("modes", K3_MODES)
def test_large_dqn_fused_modes_on_engine_frames(cuda_device, modes):
    """K3 in each of scripts/exp_large_fwd_torch.py's mode pairs on ToyCatch
    engine frames (mostly blank, so patches and their near ties repeat) and
    GA children (first-generation genomes plus one 0.002 mutation), B = 128,
    4 actions: within 1e-3·max|score| of the plain version, equal argmax
    away from near ties."""
    B, na = 128, 4
    env = AtariEnv("toy", batch_size=16, num_threads=2)
    try:
        frames = collect_ref_batch_host(env, 9, cuda_device, batch_size=B)
    finally:
        env.close()
    model = LargeDQN(num_actions=na, forward_impl="fused")
    th = _genomes(model, B, 9, cuda_device)
    th = th + 0.002 * torch.randn(th.shape, generator=torch.Generator().manual_seed(10)).to(cuda_device)
    parts, _ = model.prepare_batch_params((th, None))
    ops = dict(parts["__fused_lg__"], patches1=extract_patches(frames.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
    y = fk.large_dqn_fused_scores(ops, *modes)[:, :na]
    ref = fk.large_dqn_fused_scores_plain(ops, *modes)[:, :na]
    torch.cuda.synchronize()
    tol = 1e-3 * float(ref.abs().max())
    err = float((y - ref).abs().max())
    print(f"K3 {'/'.join(modes)} engine frames B={B}: max abs err {err} ({err / tol * 1e-3:.3g}·max)")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(y.argmax(-1)[clear], ref.argmax(-1)[clear])


# K7 and K8: (B, K, N, dtype, offset, the plan's variant). The race's
# shape at B = 16 in bf16 and float32, at B = 1 and at B = 7; B = 133 (more
# members than SMs); a tail tile (K = 296) with a partly filled column
# chunk (N = 200) on the bulk variant; on the general one: rows of W that
# are not a multiple of 16 bytes (N = 37, one element a load), W off
# 16-byte alignment (offset = 1, one element a load), and rows of x that
# are not (K = 300 bf16, K = 301 float32) beside aligned rows of W, 16-byte
# loads of 8 and 4 elements with a tail tile and a partly filled chunk.
FC_CASES = [(16, 7744, 512, torch.bfloat16, 0, "bulk"), (16, 7744, 512, torch.float32, 0, "bulk"),
            (1, 7744, 512, torch.bfloat16, 0, "bulk"), (7, 7744, 512, torch.bfloat16, 0, "bulk"),
            (133, 1024, 256, torch.bfloat16, 0, "bulk"), (5, 296, 200, torch.bfloat16, 0, "bulk"),
            (3, 300, 37, torch.bfloat16, 0, "general"), (3, 300, 40, torch.float32, 1, "general"),
            (5, 300, 200, torch.bfloat16, 0, "general"), (3, 301, 200, torch.float32, 0, "general")]
# K8, and K7's tile as a function of K and of R, the rows of the plan's
# whole unit: one row, a unit less or more one row, the race's tiles, past K
FC_KERNELS = {"whole": None, "kt1": lambda K, R: 1, "ktR-1": lambda K, R: R - 1, "ktR+1": lambda K, R: R + 1,
              "kt128": lambda K, R: 128, "kt1024": lambda K, R: 1024, "kt2048": lambda K, R: 2048,
              "kt3872": lambda K, R: 3872, "ktK+5": lambda K, R: K + 5}


@pytest.mark.parametrize("kernel", list(FC_KERNELS))
@pytest.mark.parametrize("case", FC_CASES)
def test_fc_kernels_match_plain(cuda_device, case, kernel):
    """K7 at each tile size and K8 against their plain versions: float32
    sums in another order, within 1e-5·max|y|; the plan takes the case's
    variant, each launch counts once under it, and a second launch repeats
    the first bit for bit (no atomics in any sum)."""
    B, K, N, dtype, offset, variant = case
    x, W = _k1_inputs(B, K, N, cuda_device, dtype, offset)
    if FC_KERNELS[kernel] is None:
        kt, counted = None, exp_large_fwd.fc_whole
        fn, plain = exp_large_fwd.fc_whole, exp_large_fwd.fc_whole_plain
    else:
        kt = max(1, FC_KERNELS[kernel](K, fc_matvec.plan_for(x, W).rows or 32))
        counted = exp_large_fwd.fc_ktiled

        def fn(x, W):
            return exp_large_fwd.fc_ktiled(x, W, kt)

        def plain(x, W):
            return exp_large_fwd.fc_ktiled_plain(x, W, kt)

    p = fc_matvec.plan_for(x, W, kt)
    assert p.variant == variant, p.reason
    before, by_variant = counted.launches, counted.launches_by_variant[p.variant]
    y = fn(x, W)
    ref = plain(x, W)
    again = fn(x, W)
    torch.cuda.synchronize()
    assert counted.launches == before + 2 and counted.launches_by_variant[p.variant] == by_variant + 2
    assert y.dtype == torch.float32 and y.shape == (B, N)
    torch.testing.assert_close(y, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(y, again)


VBN_KERNELS = {"fused1": (fk.vbn_dqn_fused1_scores, fk.vbn_dqn_fused1_scores_plain),
               "fused": (fk.vbn_dqn_fused_scores, fk.vbn_dqn_fused_scores_plain)}


def _vbn_ops(impl, B, num_actions, seed, device):
    """K4's ('fused1') or K6's ('fused') operands: B members around an init
    θ at the ES's σ, with the stats of 16 random reference frames."""
    model = VirtualBNDQN(num_actions=num_actions, forward_impl=impl)
    g = torch.Generator().manual_seed(seed)
    base = model.init_theta(g)
    th = (base[None] + 0.02 * torch.randn(B, model.num_params, generator=g)).to(device)
    stats = model.batch_ref_stats(th, torch.rand(16, 84, 84, 4, generator=g).to(device))
    parts, _ = model.prepare_batch_params((th, stats))
    obs = _frames(B, seed, device)
    return dict(parts["__fused__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))


# K4 and K6 at B = 1, 4 (an eval-episode group), 5 and 8, on both sides of
# the split's switch point, and at an ES round's 128 and 256
VBN_BATCHES = [1, 4, 5, 8, fk.SPLIT_MAX_B, fk.SPLIT_MAX_B + 1, 128, 256]


@pytest.mark.parametrize("num_actions", [4, 18])
@pytest.mark.parametrize("B", VBN_BATCHES)
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_matches_plain(cuda_device, impl, B, num_actions):
    """K4 and K6 against their plain versions on the card: within
    1e-3·max|score| (the bf16 roundings of x1, and of x2 in K6, kept; sums
    in f32 in other orders, the convs on tensor cores with near ties
    recomputed as sequential chains; a dropped or swapped rounding moves
    the scores by 3.7e-3·max or more, TestCardTolerance in
    test_torch_vbn_fused.py), equal argmax away from near ties, padded
    lanes at −1e9; the launch counted, by batch size too."""
    fn, plain = VBN_KERNELS[impl]
    ops = _vbn_ops(impl, B, num_actions, B + num_actions, cuda_device)
    before = fn.launches
    before_b = fn.launches_by_batch.get(B, 0)
    y = fn(ops)
    ref = plain(ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and fn.launches_by_batch[B] == before_b + 1
    assert y.shape == (B, 64) and y.dtype == torch.float32
    tol = 1e-3 * float(ref[:, :num_actions].abs().max())
    err = float((y[:, :num_actions] - ref[:, :num_actions]).abs().max())
    plan = fk.vbn_plan(B, torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    print(f"{fn.__name__} B={B} A={num_actions} split {plan.split}: max abs err {err} (tol {tol})")  # pytest -s
    torch.testing.assert_close(y[:, :num_actions], ref[:, :num_actions], rtol=0, atol=tol)
    assert bool((y[:, num_actions:] < -1e8).all())
    top2 = ref[:, :num_actions].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(y.argmax(-1)[clear], ref.argmax(-1)[clear])


@pytest.mark.parametrize("B", [1, 4, 8, fk.SPLIT_MAX_B, fk.SPLIT_MAX_B + 1, 128, 256])
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_repeats_bit_for_bit(cuda_device, impl, B):
    """Every sum of K4 and K6 runs in a fixed order, the split's partial
    rows summed in rank order by whichever block comes last: ten launches
    on the same inputs give the same scores, bit for bit."""
    fn, _ = VBN_KERNELS[impl]
    ops = _vbn_ops(impl, B, 4, B, cuda_device)
    first = fn(ops)
    ys = [fn(ops) for _ in range(10)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, y) for y in ys)


@pytest.mark.parametrize("B", [4, 128])
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_in_a_cuda_graph(cuda_device, impl, B):
    """Captured in a CUDA graph (at B = 4 the split's partial rows come from
    the graph's pool and its counters are zeroed by a captured memset) and
    replayed three times, the scores overwritten in between, K4 and K6
    repeat an eager launch bit for bit: the counters start from zero on
    every replay, so a last block runs each member's head every time."""
    fn, _ = VBN_KERNELS[impl]
    ops = _vbn_ops(impl, B, 4, B, cuda_device)
    eager = fn(ops)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture, as torch.cuda.graph asks
        fn(ops)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fn(ops)
    for _ in range(3):
        y.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, eager)


@pytest.mark.parametrize("seed", range(200, 206))
@pytest.mark.parametrize("B", [64, 128])
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_over_seeds(cuda_device, impl, B, seed):
    """K4 and K6 against their plain versions within 1e-3·max|score| at
    B = 64 (the split) and 128 (the persistent grid), members, reference
    frames and frames drawn on the card from six seeds: the check that
    caught bf16 K5's x1 flips, which a CPU emulation at B = 4 missed."""
    fn, plain = VBN_KERNELS[impl]
    gen = torch.Generator(device=cuda_device).manual_seed(seed)
    ops = vbn_random_ops(impl, B, gen, cuda_device, torch.rand((16, 84, 84, 4), generator=gen, device=cuda_device))
    y = fn(ops)[:, :4]
    ref = plain(ops)[:, :4]
    torch.cuda.synchronize()
    tol = 1e-3 * float(ref.abs().max())
    print(f"{fn.__name__} B={B} seed {seed}: max abs err {float((y - ref).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_on_engine_frames(cuda_device, impl):
    """K4 and K6 on frames from the ToyCatch engine (mostly blank, so
    patches and their near ties repeat), B = 128 perturbed members with the
    stats of the same frames: against the plain version within
    1e-3·max|score|, and a second launch bit for bit."""
    B = 128
    env = AtariEnv("toy", batch_size=16, num_threads=2)
    try:
        frames = collect_ref_batch_host(env, 11, cuda_device, batch_size=B)
    finally:
        env.close()
    model = VirtualBNDQN(num_actions=4, forward_impl=impl)
    g = torch.Generator().manual_seed(11)
    th = (model.init_theta(g)[None] + 0.02 * torch.randn(B, model.num_params, generator=g)).to(cuda_device)
    parts, _ = model.prepare_batch_params((th, model.batch_ref_stats(th, frames)))
    ops = dict(parts["__fused__"], patches1=extract_patches(frames.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
    fn, plain = VBN_KERNELS[impl]
    y = fn(ops)
    ref = plain(ops)
    again = fn(ops)
    torch.cuda.synchronize()
    tol = 1e-3 * float(ref[:, :4].abs().max())
    print(f"{fn.__name__} engine frames B={B}: max abs err {float((y - ref)[:, :4].abs().max())} (tol {tol})")
    torch.testing.assert_close(y[:, :4], ref[:, :4], rtol=0, atol=tol)
    assert torch.equal(y, again)


@pytest.mark.parametrize("B", [3, 133])
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_recomputes_every_value_past_the_tie_list(cuda_device, impl, B):
    """When a conv notes more near ties than the list holds, K4 and K6
    recompute every value of that conv as the sequential chain: on
    chip_smoke.py's vbn_all_ties_case (every x1 value, and K6's inner x2
    values, next to a bf16 midpoint; tests/test_torch_vbn_fused.py checks
    on the CPU that the tensor cores' order rounds whole channels apart
    there) the scores match the chains' within 1e-5·max|score|, at B = 3
    (the split) and 133 (the persistent grid, two members a block)."""
    fn, _ = VBN_KERNELS[impl]
    ops, want = vbn_all_ties_case(impl, B, cuda_device)
    y = fn(ops)[:, :4]
    torch.cuda.synchronize()
    tol = 1e-5 * float(want[:, :4].abs().max())
    print(f"{fn.__name__} all ties B={B}: max abs err {float((y - want[:, :4]).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, want[:, :4], rtol=0, atol=tol)


@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_wrappers_reject(cuda_device, impl):
    """A misaligned, mistyped or misshapen operand raises before a launch."""
    fn, _ = VBN_KERNELS[impl]
    ops = _vbn_ops(impl, 2, 4, 0, cuda_device)
    wkey = "wf_cm" if impl == "fused1" else "wf"
    buf = torch.zeros(ops[wkey].numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    before = fn.launches
    with pytest.raises(ValueError, match="aligned"):
        fn(dict(ops, **{wkey: buf[1:].view(ops[wkey].shape)}))
    wo_buf = torch.zeros(ops["wo"].numel() + 1, dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="wo must start 16-byte aligned"):  # a bulk copy's source too
        fn(dict(ops, wo=wo_buf[1:].view(ops["wo"].shape)))
    with pytest.raises(TypeError, match="w1"):
        fn(dict(ops, w1=ops["w1"].float()))
    with pytest.raises(ValueError, match="shape"):
        fn(dict(ops, a3=ops["a3"][:, :, :128].contiguous()))
    with pytest.raises(ValueError, match="on cpu"):
        fn(dict(ops, bo=ops["bo"].cpu()))
    assert fn.launches == before


@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_es_generation_fused_on_card(cuda_device, monkeypatch, impl):
    """A small ES generation at full width with forward_impl='fused1' (K4)
    or 'fused' (K6): the kernel launches, the 8 eval episodes run, θ' is
    finite."""
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    env = AtariEnv("toy", batch_size=8, num_threads=2)
    model = VirtualBNDQN(num_actions=env.num_actions, forward_impl=impl)
    tr = es.ESTrainer(env, model, es.ESConfig(population_size=16, episode_cutoff_mode=15),
                      optimizer=optim.Adam(0.01), noise_table=NoiseTable.from_seed(count=2_000_000),
                      device=cuda_device)
    fn, _ = VBN_KERNELS[impl]
    before = fn.launches
    stats = tr.train_step()
    tr.close()
    assert fn.launches > before
    assert stats.eval_returns.size == 8 and np.isfinite(stats.eval_returns).all()
    assert bool(torch.isfinite(tr.theta).all())


def test_ga_generation_on_card(cuda_device, monkeypatch):
    """Two small GA generations of the LargeDQN at full width on the card:
    the automatic route runs K3, and θ stays finite."""
    monkeypatch.setattr(tabular, "dump_tabular", lambda: tabular._logger._kvs.clear())
    env = AtariEnv("toy", batch_size=8, num_threads=2)
    model = LargeDQN(num_actions=env.num_actions)
    cfg = ga.GAConfig(population_size=16, selection_threshold=4, validation_threshold=2, num_validation_episodes=2,
                      num_test_episodes=2, episode_cutoff_mode=15)
    tr = ga.GATrainer(env, model, cfg, noise_table=NoiseTable.from_seed(count=5_000_000), device=cuda_device)
    before = fk.large_dqn_fused_scores.launches
    tr.train(2)
    tr.close()
    assert fk.large_dqn_fused_scores.launches > before
    assert tr.state.it == 2 and tr.cached_parent_thetas.device.type == "cuda"
    assert bool(torch.isfinite(tr.cached_parent_thetas).all())


def _graph_and_eager(monkeypatch, run):
    """``run()`` through the rollout's CUDA graphs, then eagerly (a check
    interval past the cutoff: no chunk is captured)."""
    from deep_neuroevolution_torch.algos import rollout

    graphed = run()
    monkeypatch.setattr(rollout, "CHECK_EVERY", 10**9)
    return graphed, run()


@pytest.mark.parametrize("env_id,model", [
    ("maze", ("ContinuousMLP", dict(obs_dim=11, ac_dim=2))),
    ("gym.CartPole-v1", ("SimpleClassifier", dict(obs_dim=4, num_actions=2))),
    ("gym.Pendulum-v1", ("MujocoPolicy", dict(obs_dim=3, ac_dim=1, ac_low=(-2.0,), ac_high=(2.0,),
                                              ac_bins="uniform:5", hidden_dims=(16, 16)))),
    ("gym.Pendulum-v1", ("MujocoPolicy", dict(obs_dim=3, ac_dim=1, ac_low=(-2.0,), ac_high=(2.0,),
                                              hidden_dims=(16, 16)))),
])
def test_device_rollout_graphs_match_eager(cuda_device, monkeypatch, env_id, model):
    """The device rollout through CUDA graphs repeats the eager loop bit for
    bit on the card: 64 paired members, a cutoff of 203 steps (a captured
    chunk, replays and an eager remainder), obs stats with a mask; for
    MujocoPolicy with action noise from the context's generator, which the
    graph registers (the same seed gives the same draws either way)."""
    from deep_neuroevolution_torch import envs, models
    from deep_neuroevolution_torch.algos import rollout

    env = envs.make(env_id)
    m = models.get_model(model[0])(**model[1])
    gen = torch.Generator().manual_seed(0)
    thetas = torch.stack([m.init_theta(gen) for _ in range(64)]).to(cuda_device)
    mask = (torch.arange(64, device=cuda_device) % 3 != 0).float()

    def run():
        g = torch.Generator(device=cuda_device).manual_seed(5)
        state = rollout.paired_reset(env, 32, g, cuda_device)
        ctx = None
        if m.needs_ob_stat:
            ctx = models.MLPContext(torch.zeros(3, device=cuda_device), torch.ones(3, device=cuda_device), 1.0, g, True)
        return rollout.rollout_batch(env, m.make_batch_act(), (thetas, ctx), state, 203, True, mask)

    chunk = rollout.CHECK_EVERY
    graphed, eager = _graph_and_eager(monkeypatch, run)
    for name, a, b in zip(rollout.RolloutResult._fields, graphed, eager):
        assert torch.equal(a, b), name
    assert int(eager.lengths.max()) > 2 * chunk  # past the eager first chunk: replays ran


def test_virtual_noise_on_card(cuda_device):
    """VirtualNoise rows and the device-built table on the card against the
    CPU: the threefry words equal, the normals within 1e-6; the gradient
    over a VirtualNoise within 1e-5·max|g|."""
    from deep_neuroevolution_torch.ops import fitness, noise

    vn = noise.VirtualNoise.from_seed(count=10**6, device=cuda_device)
    ids = torch.tensor([0, 7, 2**31 - 1, 999_000])
    k0, k1 = noise.fold_in_batch(vn.key, ids)
    card_bits = noise._counter_bits(k0[:, None].to(cuda_device), k1[:, None].to(cuda_device), 0, 4097, cuda_device)
    assert torch.equal(card_bits.cpu(), noise._counter_bits(k0[:, None], k1[:, None], 0, 4097, torch.device("cpu")))
    card, cpu = vn.get_batch(ids, 4097).cpu(), vn.to("cpu").get_batch(ids, 4097)
    assert float((card - cpu).abs().max()) <= 1e-6
    key = noise.prng_key(7)
    table = noise.NoiseTable.from_key(key, count=3_000_001, device=cuda_device)
    assert float((table.noise.cpu() - noise.normal(key, 3_000_001, device="cpu")).abs().max()) <= 1e-6
    w = torch.randn(4, generator=torch.Generator().manual_seed(0))
    g = fitness.gradient_from_noise(vn, ids, w.to(cuda_device), 4097).cpu()
    g_cpu = fitness.gradient_from_noise(vn.to("cpu"), ids, w, 4097)
    assert float((g - g_cpu).abs().max()) <= 1e-5 * float(g_cpu.abs().max())


def test_inspector_pca_on_card(cuda_device):
    """The inspector's 'pca' (float64) on the card against the same on the
    CPU within 1e-9·max, at a shape of each decomposition."""
    from deep_neuroevolution_torch.inspector import reduce

    rng = np.random.RandomState(0)
    for n, d in ((39, 8), (300, 16), (1026, 128)):
        X = (rng.randn(n, d) * 0.5 ** np.arange(d)) @ np.linalg.qr(rng.randn(d, d))[0]
        card = reduce.reduce_dim(X, labels=np.zeros(n), method="pca")  # device None: cuda
        cpu = reduce.reduce_dim(X, labels=np.zeros(n), method="pca", device="cpu")
        assert card.dtype == np.float64 and card.shape == (n, 2)
        assert float(np.abs(card - cpu).max()) <= 1e-9 * float(np.abs(cpu).max())


def test_inspector_replay_point_on_card(cuda_device, tmp_path):
    """``replay_point`` of a VBN-DQN offspring row on the card (device None:
    cuda): θ' bit for bit the CPU's, K1 launching, a second replay equal."""
    from deep_neuroevolution_torch.inspector import replay
    from deep_neuroevolution_torch.inspector.interactive import Point
    from deep_neuroevolution_torch.utils import checkpoint
    from deep_neuroevolution_torch.utils.vine import master_extract_cloud, master_extract_parent

    model = VirtualBNDQN(num_actions=4)
    theta = model.init_theta(torch.Generator().manual_seed(1))
    ref = torch.rand(16, 84, 84, 4, generator=torch.Generator().manual_seed(2))
    rng = np.random.RandomState(0)
    master_extract_cloud(str(tmp_path), 1, rng.randn(2, 2, 2), rng.rand(2, 2), np.full((2, 2), 9.0), [123, 456], [7, 8])
    master_extract_parent(str(tmp_path), 1, rng.randn(2, 2), rng.rand(2), np.full(2, 9.0), noise_stdev=0.02,
                          model=model, theta=theta, ref_batch=ref, seed=1)
    table = NoiseTable.from_seed(count=2 * model.num_params)
    pt = Point(1, False, 0.0, 0.0, 0.5, np.array([0.0, 0.0, 0.5, 9.0, 456, 8, -1.0]))
    k1 = population_linear.launches
    with recording_theta_override() as seen:
        runs = [replay.replay_point(str(tmp_path), pt, noise_table=table.to(cuda_device), env_id="toy")
                for _ in range(2)]
    assert population_linear.launches > k1
    _, theta_cpu, _ = checkpoint.load_policy_snapshot(replay._parent_snapshot(str(tmp_path), 1), device="cpu")
    want = replay.perturbed_theta(theta_cpu, table, 456, -0.02)
    for th in seen:
        assert th.device.type == "cuda" and torch.equal(th.cpu().view(torch.int32), want.view(torch.int32))
    assert runs[0]["returns"] == runs[1]["returns"] and runs[0]["lengths"] == runs[1]["lengths"]
