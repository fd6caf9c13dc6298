"""The VBN-DQN's routes in the port against the JAX package's
models/batchnorm.py and ops/pallas_fused_dqn.py, on the CPU, from the same
numpy inputs and the same θ: the 'full' (γ/β) affine, the 'folded' route,
``fuse_prepare``'s layouts, and the plain versions of kernels K4
(vbn_dqn_fused1_scores) and K6 (vbn_dqn_fused_scores) against the JAX
package's Pallas kernels in interpret mode; then the card kernels' sum
orders and near-tie recompute emulated against the limit the card tests
use, and their launch plan. The JAX references are built once per module;
readings print with ``pytest -s``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.models import VirtualBNDQN as TorchVBN
from deep_neuroevolution_torch.models.core import extract_patches as t_patches
from deep_neuroevolution_torch.ops import fused_dqn as tfk
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.ops import pallas_fused_dqn as jfk
from test_torch_dqn import _bmm_in_chunks, _bmm_sequential

B = 2
KERNELS = {"K4": ("one", "vbn_dqn_fused1_scores"), "K6": ("two", "vbn_dqn_fused_scores")}
CARD_LIMIT = 1e-3  # ·max|score|: chip_smoke.py and tests/test_torch_cuda.py hold K4 and K6 to it


def _inputs(jm, seed, n=B, R=8):
    """θ near a normc init (every entry perturbed, so γ − 1 ≠ 0 under
    'full'), a reference batch and frames, from numpy."""
    rs = np.random.RandomState(seed)
    base = np.asarray(jm.init_theta(jax.random.PRNGKey(seed)))
    thetas = (base[None] + 0.05 * rs.randn(n, jm.num_params)).astype(np.float32)
    return thetas, rs.rand(R, 84, 84, 4).astype(np.float32), rs.rand(n, 84, 84, 4).astype(np.float32)


def _to_torch_stats(jstats):
    from deep_neuroevolution_torch.models.batchnorm import VBNStats

    return VBNStats(*(tuple(torch.from_numpy(np.array(x)) for x in f) for f in jstats))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


class _Case:
    """One θ, its JAX stats and prepared parts, in both packages."""

    def __init__(self, num_actions, affine, seed):
        self.jm = JaxVBN(num_actions=num_actions, affine=affine, matvec_impl="xla")
        self.tm = TorchVBN(num_actions=num_actions, affine=affine)
        self.thetas, self.ref, self.obs = _inputs(self.jm, seed)
        jstats = self.jm.batch_ref_stats(jnp.asarray(self.thetas), jnp.asarray(self.ref))
        self.jparts, self.jstats = self.jm.prepare_batch_params((jnp.asarray(self.thetas), jstats))
        self.tstats = _to_torch_stats(self.jstats)  # the same stats on both sides
        self.tparts = self.tm.prepare_parts(self.tm.unflatten(weights.from_jax(self.thetas, device="cpu")))

    def layouts(self, style):
        jops = self.jm.fuse_prepare(self.jparts, self.jstats, style)
        tops = self.tm.fuse_prepare(self.tparts, self.tstats, style)
        return jops, tops

    def patches(self):
        return t_patches(torch.from_numpy(self.obs).to(torch.bfloat16), 8, 4).reshape(B, 441, 256)


@pytest.fixture(scope="module")
def cases():
    return {(na, affine): _Case(na, affine, seed) for seed, (na, affine) in
            enumerate([(4, "bias"), (18, "bias"), (4, "full"), (18, "full")])}


@pytest.fixture(scope="module")
def pallas_scores(cases):
    """The JAX kernels in interpret mode, once per (kernel, actions), on the
    'bias' cases' layouts."""
    out = {}
    for name, (style, fn) in KERNELS.items():
        for na in (4, 18):
            case = cases[(na, "bias")]
            jops, _ = case.layouts(style)
            patches1 = case.patches()
            jops = dict(jops, patches1=jnp.asarray(patches1.float().numpy()).astype(jnp.bfloat16))
            out[(name, na)] = np.asarray(getattr(jfk, fn)(jops, interpret=True))
    return out


class TestRoutes:
    def test_forward_impl_values(self):
        for impl in ("auto", "split", "folded", "fused", "fused1"):
            tm, jm = TorchVBN(num_actions=6, forward_impl=impl), JaxVBN(num_actions=6, forward_impl=impl)
            assert tm._use_fused() == jm._use_fused() and tm._use_folded() == jm._use_folded(), impl
        with pytest.raises(ValueError, match="forward_impl"):
            TorchVBN(num_actions=4, forward_impl="pallas")
        with pytest.raises(ValueError, match="affine"):
            TorchVBN(num_actions=4, affine="gamma")
        with pytest.raises(ValueError, match="64 actions"):
            TorchVBN(num_actions=65, forward_impl="fused1")
        TorchVBN(num_actions=65, forward_impl="split")  # only the fused routes pad to 64 lanes

    @pytest.mark.parametrize("impl", ["auto", "split", "folded", "fused", "fused1"])
    def test_prepare_once_and_act(self, cases, impl):
        """'auto' prepares the split route's parts; a prepared dict passes a
        second prepare unchanged; the actions are the argmax of the
        route's scores."""
        case = cases[(4, "bias")]
        tm = TorchVBN(num_actions=4, forward_impl=impl)
        th = torch.from_numpy(case.thetas)
        act = tm.make_batch_act()
        prepared = act.prepare((th, case.tstats))
        assert act.prepare(prepared) is prepared
        marker = {"fused": "__fused__", "fused1": "__fused__", "folded": "__folded__"}.get(impl)
        assert (marker in prepared[0]) if marker else not any(k.startswith("__") for k in prepared[0])
        if impl in ("fused", "fused1"):
            assert ("wf_cm" in prepared[0]["__fused__"]) == (impl == "fused1")
        obs = torch.from_numpy(case.obs)
        split_parts = tm.prepare_parts(tm.unflatten(th))
        acts = act(prepared, obs)
        if marker == "__fused__":
            scores = tm.batch_scores_fused(prepared[0]["__fused__"], obs)
        elif marker == "__folded__":
            scores = tm.batch_scores_folded(prepared[0]["__folded__"], obs)
        else:
            scores = tm.batch_scores_parts(split_parts, obs, case.tstats)
        np.testing.assert_array_equal(acts.numpy(), scores.argmax(-1).numpy())


class TestFullAffine:
    @pytest.mark.parametrize("affine", ["bias", "full"])
    def test_specs_match_jax(self, affine):
        """The same specs in the same flat order (bn_g after each bn_b), so
        weights.from_jax carries a 'full' θ across unchanged."""
        jm, tm = JaxVBN(num_actions=18, affine=affine), TorchVBN(num_actions=18, affine=affine)
        assert [(s.name, s.shape, s.init, s.std) for s in tm.specs] == [
            (s.name, s.shape, s.init, s.std) for s in jm.specs
        ]
        assert tm.num_params == jm.num_params
        assert any(s.name.endswith("bn_g") for s in tm.specs) == (affine == "full")

    def test_ref_stats_and_split_forward(self, cases):
        """Nonzero γ − 1: the moments within 1e-4 relative and the split
        route's float32 scores within 1e-4·max of the JAX package's (sums
        in another order)."""
        case = cases[(18, "full")]
        assert np.abs(case.tm.unflatten(torch.from_numpy(case.thetas))["conv1/bn_g"].numpy()).min() > 0
        th = torch.from_numpy(case.thetas)
        tstats = case.tm.batch_ref_stats(th, torch.from_numpy(case.ref))
        for j, t in zip(case.jstats.mean + case.jstats.inv_std, tstats.mean + tstats.inv_std):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-5)
        js = np.asarray(case.jm.batch_scores_parts(case.jparts, jnp.asarray(case.obs), case.jstats))
        parts, _ = case.tm.prepare_batch_params((th, tstats))
        ts = case.tm.batch_scores_parts(parts, torch.from_numpy(case.obs), tstats).numpy()
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4 * np.abs(js).max())


class TestFolded:
    @pytest.mark.parametrize("affine", ["bias", "full"])
    def test_folded_matches_split_and_jax(self, cases, affine):
        """float32: the folded route within 1e-5·max|score| of the port's
        split route and of the JAX package's batch_scores_folded, from the
        same stats (the fold reassociates the normalization)."""
        case = cases[(18, affine)]
        obs = torch.from_numpy(case.obs)
        split = case.tm.batch_scores_parts(case.tparts, obs, case.tstats).numpy()
        folded = case.tm.batch_scores_folded(case.tm.fold_batch_parts(case.tparts, case.tstats), obs).numpy()
        jfolded = np.asarray(case.jm.batch_scores_folded(case.jm.fold_batch_parts(case.jparts, case.jstats),
                                                         jnp.asarray(case.obs)))
        top = np.abs(split).max()
        print(f"folded {affine}: vs split {np.abs(folded - split).max() / top:.3g}·max, "
              f"vs JAX {np.abs(folded - jfolded).max() / top:.3g}·max")
        np.testing.assert_allclose(folded, split, rtol=0, atol=1e-5 * top)
        np.testing.assert_allclose(folded, jfolded, rtol=0, atol=1e-5 * top)


class TestFuseLayouts:
    @pytest.mark.parametrize("affine", ["bias", "full"])
    @pytest.mark.parametrize("style", ["one", "two"])
    def test_fuse_prepare_bit_equal(self, cases, style, affine):
        """Every array of K4's and K6's layout equals the JAX package's bit
        for bit, from the same θ and stats (bf16 casts are round to nearest
        even in both; a, c are the same float32 products and sums)."""
        jops, tops = cases[(18, affine)].layouts(style)
        assert sorted(tops) == sorted(jops)
        for k in jops:
            assert tuple(tops[k].shape) == tuple(jops[k].shape), k
            assert str(tops[k].dtype).replace("torch.", "") == str(jops[k].dtype), k
            np.testing.assert_array_equal(_np(tops[k]), _np(jops[k]), err_msg=k)


class TestPlainKernels:
    @pytest.mark.parametrize("num_actions", [4, 18])
    @pytest.mark.parametrize("kernel", ["K4", "K6"])
    def test_plain_matches_pallas(self, cases, pallas_scores, kernel, num_actions):
        """B=2. The plain version against the JAX kernel in interpret mode on
        the same layout: within 1e-3·max|score|, equal argmax except where
        the JAX scores' top two lie within that; the padded lanes at −1e9."""
        style, fn = KERNELS[kernel]
        case = cases[(num_actions, "bias")]
        _, tops = case.layouts(style)
        t = getattr(tfk, fn)(dict(tops, patches1=case.patches())).numpy()
        j = pallas_scores[(kernel, num_actions)]
        assert t.shape == j.shape == (B, 64)
        top = np.abs(j[:, :num_actions]).max()
        err = np.abs(t[:, :num_actions] - j[:, :num_actions]).max()
        print(f"{kernel} A={num_actions}: plain vs Pallas interpret {err / top:.3g}·max")
        np.testing.assert_allclose(t[:, :num_actions], j[:, :num_actions], rtol=0, atol=CARD_LIMIT * top)
        top2 = np.sort(j[:, :num_actions], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > CARD_LIMIT * top
        np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear])
        assert (t[:, num_actions:] < -1e8).all() and (t.argmax(-1) < num_actions).all()

    def test_wrappers_reject_what_the_kernels_do_not_take(self, cases):
        case = cases[(4, "bias")]
        for style, fn in KERNELS.values():
            _, tops = case.layouts(style)
            ops = dict(tops, patches1=case.patches())
            wkey = "wf_cm" if style == "one" else "wf"
            f = getattr(tfk, fn)
            with pytest.raises(TypeError, match=wkey):
                f(dict(ops, **{wkey: ops[wkey].float()}))
            with pytest.raises(TypeError, match="a2"):
                f(dict(ops, a2=ops["a2"].double()))
            with pytest.raises(ValueError, match="shape"):
                f(dict(ops, w2=ops["w2"][:, :128]))
            with pytest.raises(KeyError):
                f({k: v for k, v in ops.items() if k != "bo"})
            with pytest.raises(ValueError, match="contiguous"):
                f(dict(ops, wo=ops["wo"].transpose(1, 2).contiguous().transpose(1, 2)))
        _, one = case.layouts("one")
        with pytest.raises(KeyError):  # K6 does not take K4's layout
            tfk.vbn_dqn_fused_scores(dict(one, patches1=case.patches()))


def _forward(ops, acc, round_x1=True, x2_bf16=False, channel_major=True):
    """K4 (channel_major) or K6's function in ``acc`` precision, with the
    rounding of x1 (conv2's operand) and of x2 (the fc's multiplier) as
    asked."""
    n = ops["patches1"].shape[0]
    f = lambda k: ops[k].to(acc)  # noqa: E731
    x1 = torch.relu(torch.bmm(f("patches1"), f("w1")) * f("a1") + f("c1"))
    if round_x1:
        x1 = x1.to(torch.bfloat16).to(acc)
    p2 = t_patches(x1.reshape(n, 21, 21, 16), 4, 2).reshape(n, 121, 256)
    x2 = torch.relu(torch.bmm(p2, f("w2")) * f("a2") + f("c2"))
    if x2_bf16:
        x2 = x2.to(torch.bfloat16).to(acc)
    if channel_major:
        h3 = torch.einsum("bpc,bcpn->bn", x2, f("wf_cm"))
    else:
        h3 = torch.bmm(x2.reshape(n, 1, -1), f("wf"))[:, 0]
    x3 = torch.relu(h3 * f("a3")[:, 0] + f("c3")[:, 0])
    return torch.bmm(x3[:, None], f("wo"))[:, 0] + f("bo")[:, 0]


def _b4_ops(case, style):
    """K4's ('one') or K6's ('two') operands at B=4: the case's two members,
    then the same reversed and scaled by 1.01, with their own stats."""
    th = torch.from_numpy(np.concatenate([case.thetas, case.thetas[::-1] * 1.01]))
    obs = torch.from_numpy(np.concatenate([case.obs, case.obs[::-1]]))
    stats = case.tm.batch_ref_stats(th, torch.from_numpy(case.ref))
    ops = case.tm.fuse_prepare(case.tm.prepare_parts(case.tm.unflatten(th)), stats, style)
    return dict(ops, patches1=t_patches(obs.to(torch.bfloat16), 8, 4).reshape(4, 441, 256))


TIE_ULPS = 512  # csrc/dqn_ties.cuh kTieUlps
MAX_TIES = 1024  # csrc/vbn_dqn_fused.cu kMaxTies: the list a conv's near ties go to


def _near_tie(v, p):
    """csrc/dqn_ties.cuh's Ties::note under the scale and shift: v = h·a + c
    positive and within TIE_ULPS float32 ulps of max(|v|, |p|), p = h·a, of a
    bf16 rounding midpoint (v's 16 bits below bf16's are 0x8000 there)."""
    bits = v.view(torch.int32).to(torch.int64)
    e_v = (bits >> 23) & 0xFF
    e_m = (torch.maximum(v.abs(), p.abs()).view(torch.int32).to(torch.int64) >> 23) & 0xFF
    window = torch.bitwise_left_shift(torch.tensor(TIE_ULPS), (e_m - e_v).clamp(0, 7))
    return (v > 0) & (((bits & 0xFFFF) - 0x8000).abs() < window)


def _recompute(tc, p, seq):
    """Which value each conv rounds, per member: the sequential chain's where
    the tensor-core value is a near tie, or everywhere once a member's conv
    notes more than the list holds; else the tensor cores'."""
    ties = _near_tie(tc, p)
    every = ties.sum(dim=(1, 2), keepdim=True) > MAX_TIES
    return torch.where(ties | every, seq, tc)


def _first_ties_only(tc, p, seq):
    """A kernel whose tie list dropped every entry past MAX_TIES: only a
    member's first MAX_TIES near ties, in (p, co) order, take the chain."""
    ties = _near_tie(tc, p).flatten(1)
    first = ties & (ties.cumsum(1) <= MAX_TIES)
    return torch.where(first.view_as(tc), seq, tc)


def _sequential_only(tc, p, seq):
    return seq


def _conv_values(x, w, a, c):
    """A conv's h·a + c (product and sum rounded) with h in the tensor
    cores' order, its product h·a, and the same from the sequential chain."""
    p = _bmm_in_chunks(x, w) * a
    return p + c, p, _bmm_sequential(x, w) * a + c


def _kernel_order(ops, kernel, recompute, round_x1=True):
    """K4's or K6's card kernel emulated in float32: each conv's product in
    the tensor cores' order (_bmm_in_chunks: chunks of 32 k, steps of 16,
    each step summed first; conv2's two taps a chunk are its 32 consecutive
    k), then h·a + c with the product and the sum rounded; each value that
    is rounded to bf16 (x1, and K6's x2) from ``recompute(tc, p, seq)``,
    which picks per value between that and the sequential chain's; x2
    float32 in K4. The fc and the out layer in float32 (their order moves
    the scores by float32 ulps only)."""
    n = ops["patches1"].shape[0]
    f = lambda k: ops[k].float()  # noqa: E731
    x1 = torch.relu(recompute(*_conv_values(f("patches1"), f("w1"), f("a1"), f("c1"))))
    if round_x1:
        x1 = x1.to(torch.bfloat16).float()
    p2 = t_patches(x1.reshape(n, 21, 21, 16), 4, 2).reshape(n, 121, 256)
    v2, prod2, seq2 = _conv_values(p2, f("w2"), f("a2"), f("c2"))
    if kernel == "K4":
        h3 = torch.einsum("bpc,bcpn->bn", torch.relu(v2), f("wf_cm"))
    else:
        x2 = torch.relu(recompute(v2, prod2, seq2)).to(torch.bfloat16)
        h3 = torch.bmm(x2.float().reshape(n, 1, -1), f("wf"))[:, 0]
    x3 = torch.relu(h3 * f("a3")[:, 0] + f("c3")[:, 0])
    return torch.bmm(x3[:, None], f("wo"))[:, 0] + f("bo")[:, 0]


class TestCardTolerance:
    """The card limit for K4 and K6, 1e-3·max|score|, catches a kernel with
    a rounding point dropped or swapped: K4 without its bf16 rounding of
    x1 or with x2 rounded, K6 with x2 left in float32 or without the x1
    rounding, each move the scores by more than the limit, while the same
    rounding points with float64 sums stay inside it, and so does the card
    kernels' own order (tensor-core convs, near ties recomputed as
    sequential chains). B=4, 18 actions."""

    @pytest.mark.parametrize("kernel", ["K4", "K6"])
    def test_rounding_changes_exceed_the_limit(self, cases, kernel):
        case = cases[(18, "full")]
        style, fn = KERNELS[kernel]
        cm = kernel == "K4"
        ops = _b4_ops(case, style)
        na = case.tm.num_actions
        ref = getattr(tfk, fn)(ops)[:, :na].double()
        top = float(ref.abs().max())
        kept = dict(x2_bf16=not cm, channel_major=cm)
        same = float((_forward(ops, torch.float32, **kept)[:, :na] - ref).abs().max()) / top
        f64 = float((_forward(ops, torch.float64, **kept)[:, :na] - ref).abs().max()) / top
        no_x1 = float((_forward(ops, torch.float32, round_x1=False, **kept)[:, :na] - ref).abs().max()) / top
        swap_x2 = float((_forward(ops, torch.float32, x2_bf16=cm, channel_major=cm)[:, :na] - ref).abs().max()) / top
        print(f"{kernel}: same points {same:.3g}·max, float64 sums {f64:.3g}·max, "
              f"x1 not rounded {no_x1:.3g}·max, x2 {'rounded' if cm else 'float32'} {swap_x2:.3g}·max")
        assert same < 1e-6
        assert no_x1 > CARD_LIMIT > f64
        assert swap_x2 > CARD_LIMIT

    @pytest.mark.parametrize("kernel", ["K4", "K6"])
    def test_tensor_core_order_stays_inside_the_limit(self, cases, kernel):
        """The card kernel's order with its rounding points and near ties
        recomputed (_kernel_order) stays under 1e-3·max|score| against the
        plain version and against the sequential chains that the card's
        plain version sums at B ≥ 128; the same order with x1 not rounded
        exceeds it."""
        case = cases[(18, "full")]
        style, fn = KERNELS[kernel]
        ops = _b4_ops(case, style)
        na = case.tm.num_actions
        ref = getattr(tfk, fn)(ops)[:, :na]
        top = float(ref.abs().max())
        kern = _kernel_order(ops, kernel, _recompute)[:, :na]
        seq = _kernel_order(ops, kernel, _sequential_only)[:, :na]
        dropped = _kernel_order(ops, kernel, _recompute, round_x1=False)[:, :na]
        vs_plain = float((kern - ref).abs().max()) / top
        vs_seq = float((kern - seq).abs().max()) / float(seq.abs().max())
        no_x1 = float((dropped - ref).abs().max()) / top
        print(f"{kernel}: the kernel's order {vs_plain:.3g}·max against the plain version, {vs_seq:.3g}·max "
              f"against the chains; x1 not rounded {no_x1:.3g}·max")
        assert vs_plain < CARD_LIMIT and vs_seq < CARD_LIMIT
        assert no_x1 > CARD_LIMIT

    @pytest.mark.parametrize("kernel", ["K4", "K6"])
    def test_near_ties_round_as_the_sequential_chain(self, cases, kernel):
        """Every value that K4 and K6 round to bf16 (x1 in both, x2 in K6)
        equals the sequential chain's rounding once the near ties are
        recomputed, while the tensor-core order alone rounds some apart.
        K5's window, 512 ulps of v itself, leaves some apart: the shift c
        can cancel most of h·a, and the two orders' difference is a few
        ulps of h·a, not of v. The window of 512 ulps of max(|v|, |h·a|)
        catches them; it notes about a tenth of the positive values, inside
        the list of MAX_TIES a member."""
        case = cases[(18, "full")]
        style, _ = KERNELS[kernel]
        ops = _b4_ops(case, style)
        n = ops["patches1"].shape[0]
        f = lambda k: ops[k].float()  # noqa: E731

        def rounded(v):
            return torch.relu(v).to(torch.bfloat16)

        def readings(x, w, a, c):
            tc, p, seq = _conv_values(x, w, a, c)
            fixed = _recompute(tc, p, seq)
            ties = _near_tie(tc, p)
            lo = (tc.view(torch.int32) & 0xFFFF) - 0x8000
            v_window = torch.where((tc > 0) & (lo.abs() < TIE_ULPS), seq, tc)  # K5's window
            return dict(apart=int((rounded(tc) != rounded(seq)).sum()),
                        after=int((rounded(fixed) != rounded(seq)).sum()),
                        after_v_window=int((rounded(v_window) != rounded(seq)).sum()),
                        share=float(ties.sum()) / float((tc > 0).sum()), most=int(ties.sum(dim=(1, 2)).max())), fixed

        r1, fixed = readings(f("patches1"), f("w1"), f("a1"), f("c1"))
        print(f"{kernel} x1: {r1}")
        readings_all = [r1]
        if kernel == "K6":
            p2 = t_patches(rounded(fixed).float().reshape(n, 21, 21, 16), 4, 2).reshape(n, 121, 256)
            r2, _ = readings(p2, f("w2"), f("a2"), f("c2"))
            print(f"{kernel} x2: {r2}")
            readings_all.append(r2)
        for r in readings_all:
            assert r["after"] == 0 and r["share"] < 0.15 and r["most"] <= MAX_TIES
        assert sum(r["apart"] for r in readings_all) > 0
        assert sum(r["after_v_window"] for r in readings_all) > 0

    @pytest.mark.parametrize("kernel", ["K4", "K6"])
    def test_tie_list_overflow_case(self, kernel):
        """chip_smoke.py's vbn_all_ties_case, which the card holds K4 and K6
        to within 1e-5·max|score| of the sequential chains, emulated in the
        tensor cores' order: every member's x1 (and K6's x2) notes more
        near ties than the list holds and the tensor cores' order rounds at
        least a whole channel of x1 apart from the chains, so a kernel that
        recomputed only the first MAX_TIES would miss the case's scores by
        more than that limit; the kernels' rule, every value of a conv once
        its list overflows, meets it."""
        from chip_smoke import vbn_all_ties_case

        impl = "fused1" if kernel == "K4" else "fused"
        ops, want = vbn_all_ties_case(impl, 2, torch.device("cpu"))
        f = lambda k: ops[k].float()  # noqa: E731
        tc, p, seq = _conv_values(f("patches1"), f("w1"), f("a1"), f("c1"))
        noted = _near_tie(tc, p).sum(dim=(1, 2))
        apart = (torch.relu(tc).to(torch.bfloat16) != torch.relu(seq).to(torch.bfloat16)).sum(dim=(1, 2))
        want = want[:, :4]
        top = float(want.abs().max())
        first_only = float((_kernel_order(ops, kernel, _first_ties_only)[:, :4] - want).abs().max()) / top
        rule = float((_kernel_order(ops, kernel, _recompute)[:, :4] - want).abs().max()) / top
        print(f"{kernel} all ties: x1 notes {noted.tolist()}, rounds {apart.tolist()} apart; the first {MAX_TIES} "
              f"recomputed {first_only:.3g}·max, the kernels' rule {rule:.3g}·max")
        assert bool((noted > MAX_TIES).all()) and bool((apart >= 441).all())
        assert rule < 1e-5 < first_only


def _fc_kernel_order(x2, wf, plan, finish_order):
    """The kernel's fc in float32 for one member: x2 ``[3872]`` (the fc
    rows' multipliers), wf ``[3872, 256]``. Each of the plan's S blocks
    walks its rows in stages of 64, row group g (of 8) taking rows g,
    g + 8, ... of each stage and carrying its sums across stages; the
    block sums its groups in order into partials[s]. The block that
    finishes last (the last of ``finish_order``) sums partials[0..S-1] in
    rank order."""
    partials = {}
    for s in finish_order:
        r0, r1 = plan.rows(s)
        groups = torch.zeros(8, wf.shape[1])
        for q0 in range(r0, r1, 64):
            for r in range(q0, min(q0 + 64, r1)):
                g = (r - q0) % 8
                groups[g] = groups[g] + x2[r] * wf[r]  # each product exact: bf16 weights, bf16 x2 in K6
        h = torch.zeros(wf.shape[1])
        for g in range(8):
            h = h + groups[g]
        partials[s] = h
    total = torch.zeros(wf.shape[1])
    for s in range(plan.split):
        total = total + partials[s]
    return total


class TestLaunchPlan:
    """``vbn_plan``, the launch that ops/fused_dqn.py gives K4 and K6 and
    csrc/vbn_dqn_fused.cu's ``unit`` follows."""

    @pytest.mark.parametrize("sm_count", [132, 114, 16])
    def test_every_member_and_fc_row_once_within_the_sms(self, sm_count):
        for B in range(0, 300):
            p = tfk.vbn_plan(B, sm_count)
            assert p.B == B and p.sm_count == sm_count
            if B == 0:
                assert p.grid == 0
                continue
            if p.split > 1:
                # the split: S·B blocks, no more than the SMs, below the switch point
                assert B <= tfk.SPLIT_MAX_B and p.split == sm_count // B and p.grid == B * p.split <= sm_count
                bounds = [p.rows(s) for s in range(p.split)]
                assert bounds[0][0] == 0 and bounds[-1][1] == tfk.FC_ROWS
                assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])) and all(r1 > r0 for r0, r1 in bounds)
                sizes = [r1 - r0 for r0, r1 in bounds]
                assert max(sizes) - min(sizes) <= 1
            else:
                # the persistent grid: block i takes members i, i + grid, ...; each
                # takes ⌈B / SMs⌉ or one fewer, every member once
                assert p.grid <= sm_count and p.rows(0) == (0, tfk.FC_ROWS)
                per = [len(range(i, B, p.grid)) for i in range(p.grid)]
                assert sum(per) == B and max(per) == -(-B // sm_count) and min(per) >= max(per) - 1
                assert B > tfk.SPLIT_MAX_B or sm_count // B < 2
        assert tfk.vbn_plan(4, 132).split == 33 and tfk.vbn_plan(128, 132).split == 1

    def test_split_fc_sums_in_rank_order(self):
        """At B=4 on 132 SMs (S=33), the emulated split fc gives the same
        float32 bits whichever block finishes last, since the last one
        sums the partials in rank order, and it agrees with one block's
        sum (S=1) within float32 reordering."""
        g = torch.Generator().manual_seed(3)
        wf = torch.randn(tfk.FC_ROWS, 256, generator=g).to(torch.bfloat16).float()
        x2 = torch.rand(tfk.FC_ROWS, generator=g).to(torch.bfloat16).float()
        plan = tfk.vbn_plan(4, 132)
        order = list(range(plan.split))
        ranks = _fc_kernel_order(x2, wf, plan, order)
        assert torch.equal(ranks, _fc_kernel_order(x2, wf, plan, order[::-1]))
        one = _fc_kernel_order(x2, wf, tfk.vbn_plan(200, 132), [0])
        exact = (x2.double()[:, None] * wf.double()).sum(0)
        top = float(exact.abs().max())
        print(f"split fc: {float((ranks.double() - exact).abs().max()) / top:.3g}·max, one block "
              f"{float((one.double() - exact).abs().max()) / top:.3g}·max from float64")
        assert float((ranks.double() - exact).abs().max()) < 1e-5 * top
        assert float((one.double() - exact).abs().max()) < 1e-5 * top
