"""The port's CUDA kernels and its main path on a card, against the plain
PyTorch versions. Every test here needs a CUDA device, nvcc and g++, and
skips without them. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.algos import es
from deep_neuroevolution_torch.algos import ga
from deep_neuroevolution_torch.envs.atari import AtariEnv
from deep_neuroevolution_torch.models import LargeDQN, SmallDQN, VirtualBNDQN
from deep_neuroevolution_torch.models.core import extract_patches
from deep_neuroevolution_torch.ops import fused_dqn as fk
from deep_neuroevolution_torch.ops import optim
from deep_neuroevolution_torch.ops.noise import NoiseTable
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain
from deep_neuroevolution_torch.ops.population_linear import population_linear, population_linear_plain
from deep_neuroevolution_torch.utils import tabular

pytestmark = pytest.mark.cuda


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
@pytest.mark.parametrize("shape,offset,variant", [K1_CASES[0], K1_CASES[1], K1_CASES[3]])
def test_population_linear_repeats_bit_for_bit(cuda_device, shape, offset, variant, dtype):
    """No float atomics: two launches on the same inputs give the same y."""
    x, W = _k1_inputs(*shape, cuda_device, dtype, offset)
    y1 = population_linear(x, W)
    y2 = population_linear(x, W)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cls", [SmallDQN, LargeDQN])
@pytest.mark.parametrize("B", [1, 5, 256])
def test_conv_chain_matches_plain(cuda_device, B, cls, dtype):
    """K5 against its plain version on the card: float32 within 1e-5·max|x|
    (sums in another order), bfloat16 within 1e-3·max|x| (the roundings of
    the intermediates kept, as at K3)."""
    kw = {"forward_impl": "split"} if cls is LargeDQN else {}
    model = cls(num_actions=4, compute_dtype=dtype, conv_impl="fused", **kw)
    parts, _ = model.prepare_batch_params((_genomes(model, B, B, cuda_device), None))
    args = model.conv_chain_args(parts, _frames(B, B, cuda_device))
    before = fk.dqn_conv_chain_fused.launches
    y = fk.dqn_conv_chain_fused(*args)
    ref = fk.dqn_conv_chain_plain(*args)
    torch.cuda.synchronize()
    assert fk.dqn_conv_chain_fused.launches == before + 1
    assert y.shape == (B, 121, model.LAYERS[-1][1]) and y.dtype == torch.float32
    tol = (1e-5 if dtype == "float32" else 1e-3) * float(ref.abs().max())
    print(f"K5 {cls.__name__} {dtype} B={B}: max abs err {float((y - ref).abs().max())} (tol {tol})")
    torch.testing.assert_close(y, ref, rtol=0, atol=tol)


def test_fused_wrappers_reject_misaligned_inputs(cuda_device):
    """The kernels read 16-byte vectors: a misaligned operand raises."""
    model = LargeDQN(num_actions=4, forward_impl="fused")
    parts, _ = model.prepare_batch_params((_genomes(model, 1, 0, cuda_device), None))
    ops = dict(parts["__fused_lg__"], patches1=torch.zeros(1, 441, 256, dtype=torch.bfloat16, device=cuda_device))
    buf = torch.zeros(ops["wf"].numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="aligned"):
        fk.large_dqn_fused_scores(dict(ops, wf=buf[1:].view(ops["wf"].shape)))


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


@pytest.mark.parametrize("num_actions", [4, 18])
@pytest.mark.parametrize("B", [1, 5, 128])
@pytest.mark.parametrize("impl", ["fused1", "fused"])
def test_vbn_fused_matches_plain(cuda_device, impl, B, num_actions):
    """K4 and K6 against their plain versions on the card: within
    1e-3·max|score| (the bf16 roundings of x1, and of x2 in K6, kept; sums
    in f32 in other orders; a dropped or swapped rounding moves the scores
    by 3.7e-3·max or more, TestCardTolerance in test_torch_vbn_fused.py),
    equal argmax away from near ties, padded lanes at −1e9."""
    fn, plain = VBN_KERNELS[impl]
    ops = _vbn_ops(impl, B, num_actions, B + num_actions, cuda_device)
    before = fn.launches
    y = fn(ops)
    ref = plain(ops)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert y.shape == (B, 64) and y.dtype == torch.float32
    tol = 1e-3 * float(ref[:, :num_actions].abs().max())
    err = float((y[:, :num_actions] - ref[:, :num_actions]).abs().max())
    print(f"{fn.__name__} B={B} A={num_actions}: max abs err {err} (tol {tol})")  # shown with pytest -s
    torch.testing.assert_close(y[:, :num_actions], ref[:, :num_actions], rtol=0, atol=tol)
    assert bool((y[:, num_actions:] < -1e8).all())
    top2 = ref[:, :num_actions].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    assert torch.equal(y.argmax(-1)[clear], ref.argmax(-1)[clear])


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
