"""scripts/exp_large_fwd_torch.py and K3's modes against the JAX package
and scripts/exp_large_fwd.py, on the CPU.

Both scripts are imported by path; the JAX script's Pallas kernels run in
interpret mode (``pallas_call`` patched with ``interpret=True``). Inputs
are made with numpy and handed to both. Tolerances:

* K7 (``fc_ktiled``) and K8 (``fc_whole``): the plain versions against the
  JAX kernels on the same bf16 or f32 operands, within 1e-5·max|y| (f32
  sums in another order; bf16 products are exact in f32);
* K3's plain version in each mode pair against the JAX kernel: atol 0.05
  with equal argmax, as ``test_plain_k3_matches_pallas_and_split`` holds
  the default pair (tests/test_torch_dqn.py); 'mxu_t' also nearer the JAX
  'mxu_t' than that lies from the JAX 'fma', by 4× on average over the
  scores (the bf16 rounding of x3 alone sets those two apart, by about
  1e-3·max|score|, far inside 0.05);
* the conv chains: at most 1e-2·max|x| apart, and 99% of the values bit
  for bit: both round each layer's output to bf16, so a sum that lands on
  either side of a rounding midpoint moves one value by a bf16 ulp, which
  the next layers carry on.
"""

import functools
import importlib.util
import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deep_neuroevolution_torch.device import NoCudaDevice
from deep_neuroevolution_torch.models import dqn as tdqn
from deep_neuroevolution_torch.models.core import extract_patches as t_patches
from deep_neuroevolution_torch.ops import fused_dqn as tfk
from deep_neuroevolution_tpu.models import dqn as jdqn
from deep_neuroevolution_tpu.models.core import extract_patches as jax_patches
from deep_neuroevolution_tpu.ops import pallas_fused_dqn as jfk

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_exp_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


exp_t = _script("exp_large_fwd_torch")
exp_j = _script("exp_large_fwd")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX script's Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _fc_operands(B, K, N, dtype, seed):
    rs = np.random.RandomState(seed)
    x, W = rs.randn(B, K).astype(np.float32), rs.randn(B, K, N).astype(np.float32)
    tx, tW = torch.from_numpy(x).to(dtype), torch.from_numpy(W).to(dtype)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return tx, tW, jnp.asarray(x).astype(jdt), jnp.asarray(W).astype(jdt)


# K = 300 with kt = 128 pads the JAX tail tile (the port reads the 44 rows
# inside K); K = 256 is two whole tiles
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K,kt", [(300, 128), (256, 128)])
@pytest.mark.parametrize("kernel", ["fc_ktiled", "fc_whole"])
def test_fc_plain_matches_jax(interpret, kernel, K, kt, dtype):
    B, N = 3, 40
    tx, tW, jx, jW = _fc_operands(B, K, N, dtype, K + kt)
    if kernel == "fc_ktiled":
        want = np.asarray(exp_j.fc_ktiled(jx, jW, kt))
        plain, wrapped = exp_t.fc_ktiled_plain(tx, tW, kt), exp_t.fc_ktiled(tx, tW, kt)
    else:
        want = np.asarray(exp_j.fc_whole(jx, jW))
        plain, wrapped = exp_t.fc_whole_plain(tx, tW), exp_t.fc_whole(tx, tW)
    assert plain.dtype == torch.float32 and plain.shape == (B, N)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(wrapped, plain)  # a CPU tensor takes the plain version


def test_fc_ktiled_plain_adds_the_tiles_in_order():
    """K7's plain version sums each tile on its own and adds the tiles in
    order: on three tiles, that differs from the tiles summed in the other
    order only by f32 rounding, and equals the explicit chain bit for bit."""
    tx, tW, _, _ = _fc_operands(2, 300, 16, torch.bfloat16, 3)
    y = exp_t.fc_ktiled_plain(tx, tW, 128)
    parts = [torch.bmm(tx[:, None, k:k + 128].float(), tW[:, k:k + 128].float())[:, 0] for k in (0, 128, 256)]
    assert torch.equal(y, (torch.zeros_like(y) + parts[0] + parts[1]) + parts[2])
    torch.testing.assert_close(y, exp_t.fc_whole_plain(tx, tW), rtol=0, atol=1e-5 * float(y.abs().max()))


def test_fc_wrappers_reject():
    x, W = torch.zeros(2, 8), torch.zeros(2, 8, 4)
    with pytest.raises(ValueError):
        exp_t.fc_whole(x, torch.zeros(2, 7, 4))
    with pytest.raises(TypeError):
        exp_t.fc_whole(x, W.to(torch.bfloat16))
    with pytest.raises(TypeError):
        exp_t.fc_ktiled(x.double(), W.double(), 4)
    with pytest.raises(ValueError):
        exp_t.fc_ktiled(x, W, 0)
    with pytest.raises(ValueError):
        exp_t.fc_ktiled(x, W.transpose(1, 2).contiguous().transpose(1, 2), 4)


def _thetas(jm, B, seed):
    rs = np.random.RandomState(seed)
    sb = np.asarray(jm.scale_by(jm.scale_style))
    return (rs.randn(B, jm.num_params).astype(np.float32) * sb[None]).astype(np.float32)


def _obs(B, seed):
    return np.random.RandomState(seed + 100).rand(B, 84, 84, 4).astype(np.float32)


def _k3_layouts(num_actions, B, seed):
    jm = jdqn.LargeDQN(num_actions=num_actions, forward_impl="fused")
    tm = tdqn.LargeDQN(num_actions=num_actions, forward_impl="fused")
    thetas, obs = _thetas(jm, B, seed), _obs(B, seed)
    jparts, _ = jm.prepare_batch_params((jnp.asarray(thetas), None))
    tparts, _ = tm.prepare_batch_params((torch.from_numpy(thetas), None))
    jops = dict(jparts["__fused_lg__"],
                patches1=jax_patches(jnp.asarray(obs).astype(jnp.bfloat16), 8, 4, "SAME").reshape(B, 441, 256))
    tops = dict(tparts["__fused_lg__"],
                patches1=t_patches(torch.from_numpy(obs).to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
    return jops, tops


@pytest.mark.parametrize("modes", [("fma", "ksplit"), ("mxu_t", "ksplit"), ("fma", "scratch")])
def test_k3_modes_plain_match_pallas(modes):
    """B=2, 18 actions: the plain K3 in each of the script's mode pairs
    against the JAX kernel in interpret mode in the same pair. For 'mxu_t',
    whose whole effect (x3 rounded to bf16) is far inside atol 0.05, the
    port must also lie nearer the JAX 'mxu_t' than that lies from the JAX
    'fma': on average over the scores, within a quarter of that gap (a port
    that dropped the rounding reads about 1; one member's bf16 x2 rounding
    that falls apart at a midpoint, which the default pair shows too, keeps
    it above 0). The reading prints with pytest -s."""
    fc_mode, conv_mode = modes
    jops, tops = _k3_layouts(18, 2, 4)
    want = np.asarray(jfk.large_dqn_fused_scores(jops, interpret=True, fc_mode=fc_mode, conv_mode=conv_mode))
    got = tfk.large_dqn_fused_scores(tops, fc_mode=fc_mode, conv_mode=conv_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert torch.equal(torch.from_numpy(got), tfk.large_dqn_fused_scores_plain(tops, fc_mode, conv_mode))
    if fc_mode == "mxu_t":
        fma = np.asarray(jfk.large_dqn_fused_scores(jops, interpret=True, fc_mode="fma", conv_mode=conv_mode))
        gap = np.abs(want - fma)[:, :18]
        off = np.abs(got - want)[:, :18]
        print(f"mxu_t: port vs JAX {off.max():.3g} (mean {off.mean():.3g}), JAX mxu_t vs fma {gap.max():.3g} "
              f"(mean {gap.mean():.3g}), ratio of means {off.mean() / gap.mean():.3g}")
        assert gap.max() > 1e-4 * np.abs(want[:, :18]).max()
        assert off.mean() < 0.25 * gap.mean()


def test_k3_rejects_an_unknown_mode():
    """The modes are checked before the operands."""
    with pytest.raises(ValueError, match="fc_mode"):
        tfk.large_dqn_fused_scores({}, fc_mode="mxu")
    with pytest.raises(ValueError, match="conv_mode"):
        tfk.large_dqn_fused_scores_plain({}, conv_mode="split")


def _bmm_in_chunks(a, w, chunk=16):
    """a · w in float32 in K3's tensor-core order (csrc/dqn_conv_mma.cuh, as
    tests/test_torch_dqn.py emulates it): in each chunk of 32 k, step 0
    takes k 8q..8q+3 and step 1 k 8q+4..8q+7 (q < 4); each step's products
    summed exactly, the steps added in order."""
    K = a.shape[2]
    order = [c + 8 * q + 4 * s + i for c in range(0, K, 32) for s in (0, 1) for q in range(4) for i in range(4)]
    a, w = a[..., order], w[:, order]
    out = torch.zeros(a.shape[0], a.shape[1], w.shape[2], dtype=torch.float32)
    for k0 in range(0, K, chunk):
        out = out + torch.bmm(a[..., k0:k0 + chunk].double(), w[:, k0:k0 + chunk].double()).float()
    return out


def _card_order_x3(ops):
    """K3's x3 as the card computes it: every conv in the tensor cores'
    order, x1 and x2 rounded to bf16."""
    x = torch.relu(_bmm_in_chunks(ops["patches1"].float(), ops["w1"].float()) + ops["b1"])
    B = x.shape[0]
    for i, (hw, k, s) in ((2, (21, 4, 2)), (3, (11, 3, 1))):
        p = t_patches(x.to(torch.bfloat16).float().reshape(B, hw, hw, -1), k, s).reshape(B, 121, -1)
        x = torch.relu(_bmm_in_chunks(p, ops[f"w{i}"].float()) + ops[f"b{i}"])
    return x


@pytest.mark.parametrize("num_actions", [4, 18])
def test_mxu_t_rounding_is_past_the_card_limit(num_actions):
    """The card holds K3's 'mxu_t' variant to its plain version within
    1e-3·max|score|, as the default pair. B=4: the plain 'mxu_t' and 'fma'
    (x3 left in f32) lie more than that apart, so the limit catches a
    kernel that drops the bf16 rounding of x3; the kernel's own order (the
    convs on tensor cores, then x3 rounded) stays inside it. The readings
    print with pytest -s."""
    _, ops = _k3_layouts(num_actions, 4, 3)
    mxu_t = tfk.large_dqn_fused_scores_plain(ops, "mxu_t", "ksplit")[:, :num_actions]
    fma = tfk.large_dqn_fused_scores_plain(ops, "fma", "ksplit")[:, :num_actions]
    top = float(mxu_t.abs().max())
    x3 = _card_order_x3(ops).to(torch.bfloat16).float()
    h = torch.relu(torch.einsum("bpc,bcpn->bn", x3, ops["wf"].float()) + ops["bf"][:, 0])
    card = (torch.bmm(h[:, None], ops["wo"])[:, 0] + ops["bo"][:, 0])[:, :num_actions]
    dropped = float((fma - mxu_t).abs().max()) / top
    order = float((card - mxu_t).abs().max()) / top
    print(f"mxu_t A={num_actions}: x3 left in f32 {dropped:.3g}·max, the card's order {order:.3g}·max")
    assert dropped > 1e-3 > order


def test_ksplit_differs_from_scratch_in_sum_order_only():
    """'ksplit' keeps 'scratch''s rounding points and sums the taps one at
    a time: the plain versions lie within 1e-5·max|score| (a flipped bf16
    rounding of x1 or x2 would move them by ~1e-4·max or more)."""
    _, ops = _k3_layouts(18, 2, 5)
    a = tfk.large_dqn_fused_scores_plain(ops, "fma", "ksplit")[:, :18]
    b = tfk.large_dqn_fused_scores_plain(ops, "fma", "scratch")[:, :18]
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def _conv_parts(B, seed):
    kw = dict(num_actions=18, compute_dtype="bfloat16", forward_impl="split", conv_impl="einsum")
    jm, tm = jdqn.LargeDQN(**kw), tdqn.LargeDQN(**kw)
    thetas = _thetas(jm, B, seed)
    jparts, _ = jm.prepare_batch_params((jnp.asarray(thetas), None))
    tparts, _ = tm.prepare_batch_params((torch.from_numpy(thetas), None))
    return jparts, tparts, _obs(B, seed)


@pytest.mark.parametrize("chain", ["conv_chain_nhwc", "conv_chain_cf"])
def test_conv_chains_match_jax(chain):
    jparts, tparts, obs = _conv_parts(2, 6)
    want = np.asarray(getattr(exp_j, chain)(jparts, jnp.asarray(obs).astype(jnp.bfloat16)).astype(jnp.float32))
    got = getattr(exp_t, chain)(tparts, torch.from_numpy(obs).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 11, 11, 64)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 * np.abs(want).max())
    assert (got == want).mean() >= 0.99


def test_conv_cf_patches_match_jax():
    """The channels-first im2col, bit for bit."""
    x = np.random.RandomState(2).rand(2, 4, 21, 21).astype(np.float32)
    want, h2, w2 = exp_j._extract_patches_cf(jnp.asarray(x), 4, 2)
    got, th2, tw2 = exp_t._extract_patches_cf(torch.from_numpy(x), 4, 2)
    assert (th2, tw2) == (h2, w2) == (11, 11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_script_imports_no_jax_and_defaults_to_cuda():
    """The script imports torch and the port only; without ``--device cpu``
    it needs a card (NoCudaDevice here), and it catches no failure."""
    src = (ROOT / "scripts" / "exp_large_fwd_torch.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|deep_neuroevolution_tpu)\b", src, re.M)
    assert "deep_neuroevolution_tpu" not in src and "import jax" not in src
    assert "except" not in src
    if not torch.cuda.is_available():
        with pytest.raises(NoCudaDevice):
            exp_t.main(["--B", "2", "--out", "/nonexistent/never_written.json"])


def test_main_on_cpu_keeps_the_jax_keys(tmp_path):
    """``--device cpu --B 2``: every key of the committed JAX artifact's
    ``results_ms`` (results/exp_large_fwd_r04.json) holds a number, beside
    the port's own keys and the ``device`` entry; the conv routes agree."""
    out = tmp_path / "e.json"
    art = exp_t.main(["--device", "cpu", "--B", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(art))
    want = json.loads((ROOT / "results" / "exp_large_fwd_r04.json").read_text())
    ms = art["results_ms"]
    assert art["B"] == 2 and set(want["results_ms"]) <= set(ms)
    assert set(ms) - set(want["results_ms"]) == {"conv_fused", "conv_fused_kernel", *exp_t.FUSED_MODES}
    assert all(isinstance(v, float) and np.isfinite(v) for v in ms.values())
    assert ms["conv_equiv_maxdiff"] == 0.0
    assert art["device"]["card"] == "cpu" and art["device"]["host_cpu"]
