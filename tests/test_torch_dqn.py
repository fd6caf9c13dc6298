"""The GA's DQNs in the port against the JAX package's models/dqn.py and
ops/pallas_fused_dqn.py, on the CPU, from the same numpy inputs and the
same θ: specs and genome scales, the split route, and the plain versions of
kernels K3 (large_dqn_fused_scores) and K5 (dqn_conv_chain_fused) against
the JAX package's Pallas kernels in interpret mode."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.models import dqn as tdqn
from deep_neuroevolution_torch.models.core import extract_patches as t_patches
from deep_neuroevolution_torch.ops import fused_dqn as tfk
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.models import dqn as jdqn
from deep_neuroevolution_tpu.models.core import extract_patches as jax_patches
from deep_neuroevolution_tpu.ops import pallas_fused_dqn as jfk

CLASSES = ("SmallDQN", "LargeDQN", "SmallDQNXavier", "LargeDQNXavier")


def _thetas(jm, B, seed, scale=1.0):
    """B members at the GA's init scale: ε·scale_by (+ a small mutation),
    from numpy."""
    rs = np.random.RandomState(seed)
    sb = np.asarray(jm.scale_by(jm.scale_style))
    eps = rs.randn(B, jm.num_params).astype(np.float32)
    return (scale * eps * sb[None] + 0.002 * rs.randn(B, jm.num_params)).astype(np.float32)


def _obs(B, seed):
    return np.random.RandomState(seed + 100).rand(B, 84, 84, 4).astype(np.float32)


def _assert_argmax(t_scores, j_scores, tie_gap):
    """Equal argmax, except where the JAX scores' top two are closer than
    ``tie_gap``."""
    top2 = np.sort(j_scores, axis=-1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < tie_gap
    np.testing.assert_array_equal(t_scores.argmax(-1)[~near_tie], j_scores.argmax(-1)[~near_tie])


class TestSpecsAndScale:
    @pytest.mark.parametrize("name", CLASSES)
    @pytest.mark.parametrize("num_actions", [4, 18])
    def test_specs_num_params_and_scale_by(self, name, num_actions):
        """The same specs in the same order; the genome scale vector bit for
        bit (one f32 rounding of each spec's scale)."""
        jm = getattr(jdqn, name)(num_actions=num_actions)
        tm = getattr(tdqn, name)(num_actions=num_actions)
        assert [(s.name, s.shape, s.init, s.std) for s in tm.specs] == [
            (s.name, s.shape, s.init, s.std) for s in jm.specs
        ]
        assert tm.num_params == jm.num_params
        for style in ("fan_in", "base"):
            np.testing.assert_array_equal(tm.scale_by(style).numpy(), np.asarray(jm.scale_by(style)))

    def test_registry_names(self):
        for name in ("Model", "LargeModel", "SmallDQN", "LargeDQN"):
            assert tmodels.get_model(name).__name__ == jmodels.get_model(name).__name__
        assert tdqn.ModelSmall is tdqn.SmallDQN and tdqn.ModelLarge is tdqn.LargeDQN
        assert tmodels.LargeDQN(num_actions=4).num_params == 4_045_476
        assert tmodels.SmallDQN(num_actions=18).num_params == 1_008_450


def _split_scores(jm, tm, thetas, obs):
    jparts, _ = jm.prepare_batch_params((jnp.asarray(thetas), None))
    js = np.asarray(jm.batch_scores_parts(jparts, jnp.asarray(obs)))
    tparts, _ = tm.prepare_batch_params((weights.from_jax(thetas, device="cpu"), None))
    ts = tm.batch_scores_parts(tparts, torch.from_numpy(obs)).numpy()
    return js, ts


class TestSplitRoute:
    @pytest.mark.parametrize("name", ["SmallDQN", "LargeDQN"])
    def test_f32(self, name):
        """float32 scores within rtol 1e-5 (plus an atol of 1e-5 of max|score|
        for scores near 0): sums in another order."""
        thetas, obs = _thetas(getattr(jdqn, name)(num_actions=18), 3, 0), _obs(3, 0)
        kw = {"forward_impl": "split"} if name == "LargeDQN" else {}
        jm = getattr(jdqn, name)(num_actions=18, matvec_impl="xla", conv_impl="einsum", **kw)
        tm = getattr(tdqn, name)(num_actions=18, **kw)
        js, ts = _split_scores(jm, tm, thetas, obs)
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5 * np.abs(js).max())
        _assert_argmax(ts, js, 1e-5 * np.abs(js).max())

    @pytest.mark.parametrize("name", ["SmallDQN", "LargeDQN"])
    def test_bf16(self, name):
        """bfloat16 weights and activations: within atol 0.05, equal argmax
        except for bf16 near ties (ROADMAP's bar)."""
        thetas, obs = _thetas(getattr(jdqn, name)(num_actions=4), 3, 1), _obs(3, 1)
        kw = {"forward_impl": "split"} if name == "LargeDQN" else {}
        jm = getattr(jdqn, name)(num_actions=4, compute_dtype="bfloat16", matvec_impl="xla", conv_impl="einsum", **kw)
        tm = getattr(tdqn, name)(num_actions=4, compute_dtype="bfloat16", **kw)
        js, ts = _split_scores(jm, tm, thetas, obs)
        np.testing.assert_allclose(ts, js, rtol=0, atol=0.05)
        _assert_argmax(ts, js, 0.05)

    def test_auto_is_split_on_cpu_and_acts_argmax(self):
        tm = tdqn.LargeDQN(num_actions=4)
        thetas = torch.from_numpy(_thetas(jdqn.LargeDQN(num_actions=4), 2, 2))
        act = tm.make_batch_act()
        prepared = act.prepare((thetas, None))
        assert "__fused_lg__" not in prepared[0]
        obs = torch.from_numpy(_obs(2, 2))
        np.testing.assert_array_equal(act(prepared, obs).numpy(),
                                      tm.batch_scores_parts(prepared[0], obs).argmax(-1).numpy())


@functools.lru_cache(maxsize=None)
def _large_layouts(num_actions, B, seed):
    """fuse_prepare of the same θ in both packages, plus patches1 (shared
    by the tests below, which only read them)."""
    jm = jdqn.LargeDQN(num_actions=num_actions, forward_impl="fused")
    tm = tdqn.LargeDQN(num_actions=num_actions, forward_impl="fused")
    thetas, obs = _thetas(jm, B, seed), _obs(B, seed)
    jparts, _ = jm.prepare_batch_params((jnp.asarray(thetas), None))
    tparts, _ = tm.prepare_batch_params((weights.from_jax(thetas, device="cpu"), None))
    jops = dict(jparts["__fused_lg__"],
                patches1=jax_patches(jnp.asarray(obs).astype(jnp.bfloat16), 8, 4, "SAME").reshape(B, 441, 256))
    tops = dict(tparts["__fused_lg__"],
                patches1=t_patches(torch.from_numpy(obs).to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
    return jm, tm, thetas, obs, jops, tops


def _np(x):
    """numpy float32 view of a JAX or torch array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


class TestLargeFused:
    @pytest.mark.parametrize("num_actions", [4, 18])
    def test_fuse_prepare_layout_bit_equal(self, num_actions):
        """Every array of the K3 layout, and patches1, equal the JAX
        package's bit for bit (bf16 casts are round-to-nearest-even in both)."""
        _, _, _, _, jops, tops = _large_layouts(num_actions, 2, 4)
        assert sorted(tops) == sorted(jops)
        for k in jops:
            assert tuple(tops[k].shape) == tuple(jops[k].shape), k
            assert str(tops[k].dtype).replace("torch.", "") == str(jops[k].dtype), k
            np.testing.assert_array_equal(_np(tops[k]), _np(jops[k]), err_msg=k)

    @pytest.mark.parametrize("num_actions", [4, 18])
    def test_plain_k3_matches_pallas_and_split(self, num_actions):
        """B=2. The plain K3 against the JAX kernel in interpret mode: scores
        within atol 0.05 and equal argmax (the padded lanes never win). And
        against the port's own split route from the same θ (f32 weights):
        the bf16 roundings of K3 stay within atol 0.05."""
        jm, tm, thetas, obs, jops, tops = _large_layouts(num_actions, 2, 4)
        jscores = np.asarray(jfk.large_dqn_fused_scores(jops, interpret=True))
        tscores = tfk.large_dqn_fused_scores(tops).numpy()
        assert tscores.shape == (2, 64)
        np.testing.assert_allclose(tscores, jscores, rtol=0, atol=0.05)
        np.testing.assert_array_equal(tscores.argmax(-1), jscores.argmax(-1))
        assert (tscores.argmax(-1) < num_actions).all() and (tscores[:, num_actions:] < -1e8).all()
        split = tdqn.LargeDQN(num_actions=num_actions, forward_impl="split")
        parts, _ = split.prepare_batch_params((torch.from_numpy(thetas), None))
        ss = split.batch_scores_parts(parts, torch.from_numpy(obs)).numpy()
        np.testing.assert_allclose(tscores[:, :num_actions], ss, rtol=0, atol=0.05)
        _assert_argmax(tscores[:, :num_actions], ss, 0.05)
        acts = tm.batch_act_parts({"__fused_lg__": {k: v for k, v in tops.items() if k != "patches1"}},
                                  torch.from_numpy(obs))
        np.testing.assert_array_equal(acts.numpy(), tscores.argmax(-1))


class TestConvChain:
    @pytest.mark.parametrize("name", ["SmallDQN", "LargeDQN"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plain_k5_matches_pallas(self, name, dtype):
        """The plain K5 against the JAX kernel in interpret mode on the same
        prepared weights: f32 within rtol 1e-5, bf16 within 0.05."""
        jm = getattr(jdqn, name)(num_actions=4, compute_dtype=dtype, conv_impl="fused", fused_interpret=True)
        tm = getattr(tdqn, name)(num_actions=4, compute_dtype=dtype, conv_impl="fused")
        B = 2
        thetas, obs = _thetas(jm, B, 5), _obs(B, 5)
        jparts, _ = jm.prepare_batch_params((jnp.asarray(thetas), None))
        tparts, _ = tm.prepare_batch_params((weights.from_jax(thetas, device="cpu"), None))
        j = np.asarray(jm._fused_conv_acts(jparts, jnp.asarray(obs)))
        t = tdqn.fk.dqn_conv_chain_fused(*tm.conv_chain_args(tparts, torch.from_numpy(obs))).numpy()
        assert t.shape == j.shape == (B, 121, tm.LAYERS[-1][1])
        if dtype == "float32":
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * np.abs(j).max())
        else:
            np.testing.assert_allclose(t, j, rtol=0, atol=0.05)

    @pytest.mark.parametrize("name", ["SmallDQN", "LargeDQN"])
    def test_fused_conv_route_matches_einsum(self, name):
        """conv_impl='fused' against 'einsum' in the port, float32: the same
        products in another order, within 1e-5 of max|score|."""
        thetas, obs = _thetas(getattr(jdqn, name)(num_actions=4), 2, 6), _obs(2, 6)
        kw = {"forward_impl": "split"} if name == "LargeDQN" else {}
        scores = []
        for impl in ("fused", "einsum"):
            tm = getattr(tdqn, name)(num_actions=4, conv_impl=impl, **kw)
            parts, _ = tm.prepare_batch_params((torch.from_numpy(thetas), None))
            scores.append(tm.batch_scores_parts(parts, torch.from_numpy(obs)).numpy())
        np.testing.assert_allclose(scores[0], scores[1], rtol=0, atol=1e-5 * np.abs(scores[1]).max())


def _chain(p1, convs, acc, rounded, mm=torch.bmm):
    """The conv stack in ``acc`` precision; ``rounded`` rounds each product's
    operand to its weight dtype, as K3 and K5 do; ``mm`` takes each product."""
    x = torch.relu(mm(p1.to(acc), convs[0][0].to(acc)) + convs[0][1].to(acc))
    B = x.shape[0]
    for (w, b), (hw, k, s) in zip(convs[1:], ((21, 4, 2), (11, 3, 1))):
        if rounded:
            x = x.to(w.dtype)
        pt = t_patches(x.to(acc).reshape(B, hw, hw, -1), k, s).reshape(B, 121, -1)
        x = torch.relu(mm(pt, w.to(acc)) + b.to(acc))
    return x


def _mma_steps(K):
    """K3's k order on the tensor cores (csrc/dqn_conv_mma.cuh): in each
    chunk of 32, step 0 takes k 8q..8q+3 and step 1 k 8q+4..8q+7, q < 4."""
    return [c + 8 * q + 4 * s + i for c in range(0, K, 32) for s in (0, 1) for q in range(4) for i in range(4)]


def _bmm_in_chunks(a, w, chunk=16):
    """a · w in float32 the way K3's tensor-core product sums: K in the
    kernel's steps of ``chunk``, each step's products summed first (exactly,
    then rounded to float32), the steps' sums added in order."""
    order = _mma_steps(a.shape[2])
    a, w = a[..., order], w[:, order]
    out = torch.zeros(a.shape[0], a.shape[1], w.shape[2], dtype=torch.float32)
    for k0 in range(0, a.shape[2], chunk):
        out = out + torch.bmm(a[..., k0:k0 + chunk].double(), w[:, k0:k0 + chunk].double()).float()
    return out


def _k3_case(num_actions, B, seed):
    """K3's operands at B members, its convs, and the plain K3's scores."""
    tm = tdqn.LargeDQN(num_actions=num_actions, forward_impl="fused")
    parts, _ = tm.prepare_batch_params((torch.from_numpy(_thetas(tm, B, seed)), None))
    patches = t_patches(torch.from_numpy(_obs(B, seed)).to(torch.bfloat16), 8, 4)
    ops = dict(parts["__fused_lg__"], patches1=patches.reshape(B, 441, 256))
    convs = [(ops[f"w{i}"], ops[f"b{i}"]) for i in (1, 2, 3)]
    return ops, convs, tfk.large_dqn_fused_scores_plain(ops)[:, :num_actions]


def _k3_head(ops, x3, acc, num_actions):
    """K3's fc and out layer on the conv stack's x3, in ``acc`` precision."""
    h = torch.relu(torch.einsum("bpc,bcpn->bn", x3, ops["wf"].to(acc)) + ops["bf"][:, 0].to(acc))
    return (torch.bmm(h[:, None], ops["wo"].to(acc))[:, 0] + ops["bo"][:, 0].to(acc))[:, :num_actions]


def _bmm_sequential(a, w):
    """a · w as a sequential float32 chain in k order from 0 (K5's first kernel, and
    cuBLAS's order for the plain version at B = 128 and 256): each bf16
    product is exact in float32, each add rounded."""
    out = torch.zeros(a.shape[0], a.shape[1], w.shape[2])
    for k in range(a.shape[2]):
        out = out + a[..., k:k + 1] * w[:, k:k + 1, :]
    return out


K5_TIE_ULPS = 512  # csrc/dqn_conv_chain.cu kTieUlps
K5_MAX_TIES = 512  # csrc/dqn_conv_chain.cu kMaxTies


def _near_tie(v):
    """csrc/dqn_conv_chain.cu's Ties::note: a positive float32 within
    K5_TIE_ULPS of a bf16 rounding midpoint."""
    lo = (v.view(torch.int32) & 0xFFFF).to(torch.int64)
    return (v > 0) & ((lo - 0x8000).abs() < K5_TIE_ULPS)


def _k5_recompute(tc, seq):
    """Which sums bf16 K5 rounds, per member: the sequential chain's where
    the tensor-core value is a near tie, or everywhere once a member's conv
    notes more than its list holds (K5_MAX_TIES); else the tensor cores'."""
    ties = _near_tie(tc)
    every = ties.sum(dim=(1, 2), keepdim=True) > K5_MAX_TIES
    return torch.where(ties | every, seq, tc)


def _first_ties_only(tc, seq):
    """A kernel whose tie list dropped every entry past K5_MAX_TIES: only a
    member's first K5_MAX_TIES near ties, in (p, co) order, take the chain."""
    ties = _near_tie(tc).flatten(1)
    first = ties & (ties.cumsum(1) <= K5_MAX_TIES)
    return torch.where(first.view_as(tc), seq, tc)


def _k5_args(model, B, seed):
    """bf16 K5's arguments for B members of ``model`` (a class name) at
    _thetas's scale and random frames."""
    tm = getattr(tdqn, model)(num_actions=4, compute_dtype="bfloat16", conv_impl="fused",
                              **({"forward_impl": "split"} if model == "LargeDQN" else {}))
    parts, _ = tm.prepare_batch_params((torch.from_numpy(_thetas(tm, B, seed)), None))
    return [a for a in tm.conv_chain_args(parts, torch.from_numpy(_obs(B, seed))) if a is not None]


def _k5_kernel_order(args, recompute):
    """bf16 K5's output emulated: each conv's product in the tensor cores'
    order (_bmm_in_chunks); x1 (and x2) relu'd and rounded to bf16 from
    ``recompute(tc, seq)``, which picks per value between the tensor-core
    sum and the sequential chain's; the last conv float32, unrounded."""
    convs = list(zip(args[1::2], args[2::2]))
    B = args[0].shape[0]
    x = args[0].float()
    for i, (w, b) in enumerate(convs):
        if i:
            hw, k, s = ((21, 4, 2), (11, 3, 1))[i - 1]
            x = t_patches(x.reshape(B, hw, hw, -1), k, s).reshape(B, 121, -1)
        v = _bmm_in_chunks(x, w.float()) + b
        if i == len(convs) - 1:
            return torch.relu(v)
        x = torch.relu(recompute(v, _bmm_sequential(x, w.float()) + b)).to(torch.bfloat16).float()


class TestCardTolerance:
    """The limit that chip_smoke.py and tests/test_torch_cuda.py hold K3 and
    bf16 K5 to, 1e-3·max|out|, catches a kernel that drops the bf16
    roundings of x1 and x2: leaving them out moves the output by more than
    1e-3·max, while the same rounding points summed in float64 instead of
    float32 stay inside it. B=4; the readings print with pytest -s."""

    @pytest.mark.parametrize("case", ["K3-4", "K3-18", "K5-SmallDQN", "K5-LargeDQN"])
    def test_dropped_roundings_exceed_the_limits(self, case):
        kernel, arg = case.split("-")
        B = 4
        if kernel == "K3":
            ops, convs, ref = _k3_case(int(arg), B, 7)

            def out(acc, rounded):
                return _k3_head(ops, _chain(ops["patches1"], convs, acc, rounded), acc, int(arg))

        else:
            tm = getattr(tdqn, arg)(num_actions=4, compute_dtype="bfloat16", conv_impl="fused",
                                    **({"forward_impl": "split"} if arg == "LargeDQN" else {}))
            parts, _ = tm.prepare_batch_params((torch.from_numpy(_thetas(tm, B, 8)), None))
            args = [a for a in tm.conv_chain_args(parts, torch.from_numpy(_obs(B, 8))) if a is not None]
            convs = list(zip(args[1::2], args[2::2]))

            def out(acc, rounded):
                return _chain(args[0], convs, acc, rounded)

            ref = tfk.dqn_conv_chain_plain(*args)
        top = float(ref.abs().max())
        np.testing.assert_allclose(out(torch.float32, True).numpy(), ref.numpy(), rtol=0, atol=1e-6 * top)
        dropped = float((out(torch.float32, False) - ref).abs().max()) / top
        f64 = float((out(torch.float64, True) - ref.double()).abs().max()) / top
        print(f"{case}: dropped roundings {dropped:.3g}·max, float64 sums {f64:.3g}·max")
        assert dropped > 1e-3 > f64

    @pytest.mark.parametrize("num_actions", [4, 18])
    def test_k3_tensor_core_order_stays_inside_the_limit(self, num_actions):
        """K3's convs on tensor cores sum each product in steps of 16 k,
        each step first, then the steps in order. With the same rounding
        points that order moves the scores by less than 1e-3·max, while
        dropping the roundings moves them by more."""
        ops, convs, ref = _k3_case(num_actions, 4, 7)
        top = float(ref.abs().max())
        x3 = _chain(ops["patches1"], convs, torch.float32, True, mm=_bmm_in_chunks)
        chunked = float((_k3_head(ops, x3, torch.float32, num_actions) - ref).abs().max()) / top
        x3 = _chain(ops["patches1"], convs, torch.float32, False, mm=_bmm_in_chunks)
        dropped = float((_k3_head(ops, x3, torch.float32, num_actions) - ref).abs().max()) / top
        print(f"K3-{num_actions}: steps of 16 {chunked:.3g}·max, the same with dropped roundings {dropped:.3g}·max")
        assert chunked < 1e-3 < dropped

    @pytest.mark.parametrize("model", ["SmallDQN", "LargeDQN"])
    def test_k5_tensor_core_order_stays_inside_the_limit(self, model):
        """bf16 K5 runs K3's tensor-core stages: each product in chunks of
        32 k, steps of 16 in the kernel's lane order, each step summed first
        and the steps in order. The SmallDQN's conv2 (16 channels a tap)
        takes two taps a chunk, which in (i, j, c) order are the chunk's 32
        consecutive k, so the same emulation holds. With K5's rounding
        points that order stays under 1e-3·max|x|; dropped roundings exceed
        it. The kernel as built (near ties recomputed as sequential chains,
        _k5_kernel_order) stays under it against the plain version and
        against the sequential chains that the card's plain version sums at
        B ≥ 128. The order alone is not enough: on some inputs (seed 60 at
        B = 4) it flips x1 roundings that flip more of the LargeDQN's x2,
        past the limit against the chains, as on the card."""
        args = _k5_args(model, 4, 9)
        convs = list(zip(args[1::2], args[2::2]))
        ref = tfk.dqn_conv_chain_plain(*args)
        top = float(ref.abs().max())
        chunked = float((_chain(args[0], convs, torch.float32, True, mm=_bmm_in_chunks) - ref).abs().max()) / top
        dropped = float((_chain(args[0], convs, torch.float32, False, mm=_bmm_in_chunks) - ref).abs().max()) / top
        kernel = _k5_kernel_order(args, _k5_recompute)
        seq = _chain(args[0], convs, torch.float32, True, mm=_bmm_sequential)
        vs_plain = float((kernel - ref).abs().max()) / top
        vs_seq = float((kernel - seq).abs().max()) / float(seq.abs().max())
        print(f"K5-{model}: steps of 16 {chunked:.3g}·max, the same with dropped roundings {dropped:.3g}·max; "
              f"the kernel's order {vs_plain:.3g}·max against the plain version, {vs_seq:.3g}·max against the chains")
        assert chunked < 1e-3 < dropped
        assert vs_plain < 1e-3 and vs_seq < 1e-3
        if model == "LargeDQN":
            args = _k5_args(model, 4, 60)
            seq = _chain(args[0], list(zip(args[1::2], args[2::2])), torch.float32, True, mm=_bmm_sequential)
            top = float(seq.abs().max())
            alone = float((_k5_kernel_order(args, lambda tc, sq: tc) - seq).abs().max()) / top
            fixed = float((_k5_kernel_order(args, _k5_recompute) - seq).abs().max()) / top
            print(f"K5-{model} seed 60 against the chains: the order alone {alone:.3g}·max, near ties recomputed "
                  f"{fixed:.3g}·max")
            assert fixed < 1e-5 and alone > 1e-3

    @pytest.mark.parametrize("model", ["SmallDQN", "LargeDQN"])
    def test_k5_near_ties_round_as_the_sequential_chain(self, model):
        """bf16 K5 recomputes each bf16 intermediate whose tensor-core
        value lies within 512 float32 ulps of a rounding midpoint as a
        sequential float32 chain. On the card one flipped x1 rounding moved
        later sums enough to flip more of x2 and took the LargeDQN past the
        1e-3·max limit (B=5). Emulated here on conv1: the tensor-core order
        alone rounds some values apart from the chain; with the near ties
        recomputed every rounding matches it, and the ties are a few
        percent of the values, inside the kernel's list of 512 a conv
        (past which it recomputes every value)."""
        B = 4
        args = _k5_args(model, B, 11)
        p1, w1, b1 = args[0].float(), args[1].float(), args[2]
        seq = _bmm_sequential(p1, w1) + b1
        tc = _bmm_in_chunks(p1, w1) + b1
        ties = _near_tie(tc)
        fixed = _k5_recompute(tc, seq)

        def rounded(v):
            return torch.relu(v).to(torch.bfloat16)

        apart = int((rounded(tc) != rounded(seq)).sum())
        after = int((rounded(fixed) != rounded(seq)).sum())
        share = float(ties.sum()) / float((tc > 0).sum())
        print(f"K5-{model} conv1: {apart} roundings apart, {after} after the ties, ties {share:.3%} of the positive values")
        assert apart > 0 and after == 0
        assert share < 0.03 and int(ties.sum(dim=(1, 2)).max()) <= K5_MAX_TIES

    @pytest.mark.parametrize("model", ["SmallDQN", "LargeDQN"])
    def test_k5_tie_list_overflow_case(self, model):
        """tests/test_torch_cuda.py's k5_all_ties_case, which the card test
        test_conv_chain_recomputes_every_value_past_the_tie_list holds K5
        to within 1e-5·max|x|, emulated in the tensor cores' order: every
        member's x1 notes far more near ties than K5's list holds, and the
        tensor cores' order rounds at least one whole channel (441 values)
        apart from the chains, so a kernel that recomputed only its first
        512 would miss the case's output by far more than that limit;
        recomputing every value meets it."""
        from test_torch_cuda import k5_all_ties_case

        cls = getattr(tdqn, model)
        args, want = k5_all_ties_case(cls, 3, torch.device("cpu"))
        p1, w1, b1 = args[0].float(), args[1].float(), args[2]
        tc = _bmm_in_chunks(p1, w1) + b1
        seq = _bmm_sequential(p1, w1) + b1
        noted = _near_tie(tc).sum(dim=(1, 2))
        apart = (torch.relu(tc).to(torch.bfloat16) != torch.relu(seq).to(torch.bfloat16)).sum(dim=(1, 2))
        top = float(want.abs().max())
        first_512 = float((_k5_kernel_order(args, _first_ties_only) - want).abs().max()) / top
        every = float((_k5_kernel_order(args, _k5_recompute) - want).abs().max()) / top
        print(f"K5-{model} all ties: x1 notes {noted.tolist()}, rounds {apart.tolist()} apart; the first 512 "
              f"recomputed {first_512:.3g}·max, every value {every:.3g}·max")
        assert bool((noted > K5_MAX_TIES).all()) and bool((apart >= 441).all())
        assert every < 1e-5 < 1e-4 < first_512


class TestWrapperChecks:
    def test_wrappers_reject_what_the_kernels_do_not_take(self):
        B = 1
        z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)  # noqa: E731
        with pytest.raises(ValueError, match="conv widths"):
            tfk.dqn_conv_chain_fused(z(B, 441, 256), z(B, 256, 8), z(B, 1, 8), z(B, 128, 32), z(B, 1, 32))
        with pytest.raises(TypeError, match="dtype"):
            tfk.dqn_conv_chain_fused(z(B, 441, 256), z(B, 256, 16, dt=torch.bfloat16), z(B, 1, 16),
                                     z(B, 256, 32), z(B, 1, 32))
        with pytest.raises(ValueError, match="shape"):
            tfk.dqn_conv_chain_fused(z(B, 440, 256), z(B, 256, 16), z(B, 1, 16), z(B, 256, 32), z(B, 1, 32))
        _, _, _, _, _, tops = _large_layouts(4, 1, 7)
        with pytest.raises(TypeError, match="wf"):
            tfk.large_dqn_fused_scores(dict(tops, wf=tops["wf"].float()))
        with pytest.raises(KeyError):
            tfk.large_dqn_fused_scores({k: v for k, v in tops.items() if k != "bo"})
        with pytest.raises(ValueError, match="contiguous"):
            tfk.large_dqn_fused_scores(dict(tops, wo=tops["wo"].transpose(1, 2).contiguous().transpose(1, 2)))
