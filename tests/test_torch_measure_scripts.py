"""The port's measurement scripts against the JAX package's, on the CPU.

scripts/profile_atari_stages_torch.py, bench_atari_e2e_torch.py,
bench_engine_torch.py, scaling_study_torch.py and local_run_exp_torch.sh
are the counterparts of the JAX scripts of the same name without
``_torch``. The Python ones are imported by path; Pallas kernels run in
interpret mode (``pallas_call`` patched, as tests/test_torch_exp_large_fwd.py
does). Tolerances:

* stage parity: each profile stage's builder at B=2, t = 0 and 1, fed the
  same numpy inputs as the JAX package's functions that the JAX script's
  step runs. The palette gather, the im2col, the frame stack and the
  argmax bit for bit; the resizes within 1e-6 (float32 products in another
  order). Products with float32 outputs (K1's plain version, the convs, a
  float32 ``torch.bmm``) within 1e-5·max|y|, bf16 operands included (their
  products are exact in float32); a bf16 ``torch.bmm`` rounds its output
  to bf16, so within 2⁻⁸·|y| + 1e-5·max|y|. A bf16 tanh of the perturbed
  input within one bf16 ulp (the libraries' float32 tanh differ in the last
  bits; the product is then compared on the JAX input). Conv chains that
  round each layer to bf16: within 1e-2·max|y| and 99% of the values within
  1e-5·max|y| (a value on either side of a rounding midpoint moves by an
  ulp, which the next layer carries on). The routes' scores: float32 within
  1e-5·max|score|; bf16 (the split and folded routes, K3, K4 and K6) within
  1e-3·max|score|, as tests/test_torch_cuda.py holds the bf16 kernels, and
  K3, K4 and K6 also within ROADMAP.md's atol 0.05. Actions equal (and the
  argmax of the port's own scores) except where the JAX scores' top two lie
  within twice that bound (a near tie); each route compares some rows.
* dry runs: each script on ``--device cpu`` at a tiny size; its artifact's
  keys are the JAX artifact's plus ``device``.
* the engine: both scripts' ``bench_backend`` count the same resets.
"""

import functools
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from deep_neuroevolution_torch.device import NoCudaDevice
from deep_neuroevolution_torch.envs import preprocess as tpre
from deep_neuroevolution_torch.models import LargeDQN, VirtualBNDQN
from deep_neuroevolution_torch.models.batchnorm import VBNStats
from deep_neuroevolution_tpu.envs import preprocess as jpre
from deep_neuroevolution_tpu.models import dqn as jdqn
from deep_neuroevolution_tpu.models.batchnorm import VBNStats as JVBNStats
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JVBN
from deep_neuroevolution_tpu.models.core import batch_conv2d as j_conv
from deep_neuroevolution_tpu.models.core import extract_patches as j_patches
from deep_neuroevolution_tpu.ops.pallas_forward import population_linear as j_pop_linear

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
RESULTS = ROOT / "results"
PORT_SCRIPTS = ("profile_atari_stages_torch", "bench_atari_e2e_torch", "bench_engine_torch", "scaling_study_torch")
B, NA = 2, 18
BF16_ULP = 2.0 ** -8  # relative spacing of bf16 values: rounding moves a value by at most half of it
F32_SCORES = 1e-5  # ·max|score|: the float32 routes (sums in another order)
BF16_SCORES = 1e-3  # ·max|score|: the bf16 routes, as tests/test_torch_cuda.py holds the bf16 kernels
FUSED_ATOL = 0.05  # K3, K4 and K6 against the JAX kernels: ROADMAP.md's bar


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_measure_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


prof_t = _script("profile_atari_stages_torch")
e2e_t = _script("bench_atari_e2e_torch")
eng_t = _script("bench_engine_torch")
scal_t = _script("scaling_study_torch")
race_t = _script("exp_large_fwd_torch")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


# ----------------------------------------------------------- the scripts

@pytest.mark.parametrize("name", PORT_SCRIPTS + ("marginal_torch",))
def test_scripts_import_no_jax_and_default_to_cuda(name):
    """torch, numpy and the port only; ``--device`` defaults to cuda, and
    nothing falls back to the CPU."""
    src = (SCRIPTS / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|deep_neuroevolution_tpu)\b", src, re.M)
    assert "deep_neuroevolution_tpu" not in src and "import jax" not in src
    assert "except" not in src
    if name != "marginal_torch":
        assert re.search(r'"--device", default=None, help="cuda \(default\) or cpu"', src)


def test_the_race_and_the_profile_share_one_timer():
    assert prof_t.marginal is race_t.marginal
    assert prof_t.fc_bmm is race_t.fc_bmm and prof_t.conv_chain_nhwc is race_t.conv_chain_nhwc
    ms = prof_t.marginal(lambda t: torch.ones(3).sum() * t, torch.device("cpu"), reps=1)
    assert math.isfinite(ms)


@pytest.mark.parametrize("mod", [prof_t.run, e2e_t.main, eng_t.main, scal_t.main],
                         ids=["profile", "e2e", "engine", "scaling"])
def test_mains_ask_for_a_card(mod, tmp_path):
    """Without ``--device cpu`` a script needs a card: NoCudaDevice here,
    before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NoCudaDevice):
        mod(["--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_local_launcher_needs_a_card(tmp_path):
    """``local_run_exp_torch.sh es maze_es.json LOG`` runs ``main train``:
    here it stops with "no CUDA device" and trains nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = (SCRIPTS / "local_run_exp_torch.sh").read_text()
    assert "exec python -m deep_neuroevolution_torch.main train" in src and "--snapshot_freq 10" in src
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "python").write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')  # the tests' interpreter
    (bindir / "python").chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    log = tmp_path / "log"
    p = subprocess.run(["bash", str(SCRIPTS / "local_run_exp_torch.sh"), "es", "configurations/maze_es.json", str(log)],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr + p.stdout
    rows = (log / "metrics.jsonl").read_text() if (log / "metrics.jsonl").exists() else ""
    assert rows.strip() == "" and not (log / "snapshot.pkl").exists()  # not one generation ran


# ----------------------------------------------------------- stage parity

def _zeros_ones(B_, mod_stats, zeros, ones):
    return mod_stats(tuple(zeros((B_, c)) for c in (16, 32, 256)), tuple(ones((B_, c)) for c in (16, 32, 256)))


@pytest.fixture(scope="module")
def cases():
    """The same numpy inputs for both packages, from one seed."""
    rs = np.random.RandomState(24)
    small, large = VirtualBNDQN(num_actions=NA), LargeDQN(num_actions=NA)
    reinit = lambda m: m.reinit_theta(torch.from_numpy(rs.randn(B, m.num_params).astype(np.float32))).numpy()  # noqa: E731
    return SimpleNamespace(
        frames=rs.randint(0, 256, size=(B, 2, 210, 160)).astype(np.uint8),
        x=rs.randn(B, 3872).astype(np.float32), W=rs.randn(B, 3872, 256).astype(np.float32),
        obs=rs.rand(B, 84, 84, 4).astype(np.float32),
        theta=reinit(small), theta_large=reinit(large),
        h1=rs.rand(B, 21, 21, 32).astype(np.float32), h2=rs.rand(B, 11, 11, 64).astype(np.float32),
        xf=rs.randn(B, 7744).astype(np.float32), frame=rs.rand(B, 84, 84, 1).astype(np.float32),
        scores=rs.rand(B, 1, 64).astype(np.float32),
        tstats=_zeros_ones(B, VBNStats, torch.zeros, torch.ones),
        jstats=_zeros_ones(B, JVBNStats, jnp.zeros, jnp.ones),
    )


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel_max=1e-5, rel_each=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rel_each, atol=rel_max * np.abs(want).max())


def _chain_close(got, want):
    """Conv chains rounded to bf16 at each layer (see the module docstring)."""
    got, want = _np(got), _np(want)
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * top
    assert (np.abs(got - want) <= 1e-5 * top).mean() >= 0.99


def _bound(j_scores, rel):
    """``rel``·max|score| of the JAX scores (the first NA lanes)."""
    return rel * float(np.abs(_np(j_scores)[:, :NA]).max())


def _fused_bound(j_scores):
    """K3, K4 and K6 against the JAX kernels: the bf16 bound, or ROADMAP.md's
    bar where that is tighter (it is not at these scores)."""
    return min(FUSED_ATOL, _bound(j_scores, BF16_SCORES))


def _actions_agree(t_act, j_act, t_scores, j_scores, bound):
    """The port's scores within ``bound`` of JAX's; the port's actions
    JAX's and its own scores' argmax, except where JAX's top two scores lie
    within 2·bound (a near tie, which either side may win). Returns the
    rows whose actions were compared."""
    t_scores, j_scores = _np(t_scores)[:, :NA], _np(j_scores)[:, :NA]
    diff = float(np.abs(t_scores - j_scores).max())
    print(f"  scores {diff / np.abs(j_scores).max():.3g}·max apart (bound {bound / np.abs(j_scores).max():.3g}·max)")
    assert diff <= bound, (diff, bound)
    top2 = np.sort(j_scores, axis=-1)[:, -2:]
    far = (top2[:, 1] - top2[:, 0]) > 2 * bound
    t_act, j_act = np.asarray(t_act), np.asarray(j_act)
    np.testing.assert_array_equal(j_act, j_scores.argmax(-1))
    np.testing.assert_array_equal(t_act[far], j_act[far])
    np.testing.assert_array_equal(t_act[far], t_scores.argmax(-1)[far])
    return int(far.sum())


@pytest.mark.parametrize("rel", [F32_SCORES, BF16_SCORES])
def test_actions_agree_catches_a_wrong_port(rel):
    """The check fails on a score moved past its bound, on scores far off
    (the near-tie window does not widen with them) and on an action flipped
    outside a near tie."""
    rs = np.random.RandomState(7)
    j = rs.randn(4, NA).astype(np.float32)
    bound, acts = _bound(j, rel), j.argmax(-1)
    assert _actions_agree(acts, acts, j, j, bound) == 4
    moved = j.copy()
    moved[1, 3] += 1.5 * bound
    far_off = j + rs.randn(4, NA).astype(np.float32)
    flipped = acts.copy()
    flipped[2] = (flipped[2] + 1) % NA
    for t_act, t_scores in ((acts, moved), (far_off.argmax(-1), far_off), (flipped, j)):
        with pytest.raises(AssertionError):
            _actions_agree(t_act, acts, t_scores, j, bound)


def _jt(t, dtype=jnp.float32):
    return jnp.asarray(t, jnp.int32).astype(dtype)


def _check_rng_frames(c):
    gen = torch.Generator().manual_seed(0)
    step = prof_t.rng_frames_step(B, gen)
    a, b = step(0), step(1)
    assert a.dtype == torch.int32 and a.shape == (B, 2, 210, 160)
    assert int(a.min()) >= 0 and int(a.max()) <= 255 and not torch.equal(a, b)


def _check_palette(c):
    for t in (0, 1):
        got = prof_t.palette_step(torch.from_numpy(c.frames))(t)
        want = jnp.asarray(jpre.GRAYSCALE_PALETTE)[(jnp.asarray(c.frames) + _jt(t, jnp.uint8)).astype(jnp.int32)]
        np.testing.assert_array_equal(_np(got), _np(want))


def _check_preprocess(c, gray):
    jfn = jpre.preprocess_gray_frames if gray else jpre.preprocess_frames
    for t in (0, 1):
        got = prof_t.preprocess_step(torch.from_numpy(c.frames), gray)(t)
        want = jfn(jnp.asarray(c.frames) + _jt(t, jnp.uint8), 84, 84)
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)


def _fc_operands(c, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return (torch.from_numpy(c.x).to(dtype), torch.from_numpy(c.W).to(dtype), jnp.asarray(c.x).astype(jdt),
            jnp.asarray(c.W).astype(jdt), jdt)


def _fc_tol(name, got, want):
    if "xla" in name and "bf16" in name:
        _close(got, want, rel_each=BF16_ULP)  # torch.bmm's bf16 output, rounded
    else:
        _close(got, want)


def _check_tanh_input(tx, jx, t, jdt):
    """The tanh-perturbed input, within one bf16 ulp of JAX's; returns
    JAX's as a torch tensor."""
    xp_t, xp_j = torch.tanh(tx + t), jnp.tanh(jx + _jt(t, jdt))
    np.testing.assert_allclose(_np(xp_t), _np(xp_j), rtol=BF16_ULP, atol=0)
    return xp_t, torch.from_numpy(_np(xp_j).copy()).to(tx.dtype), xp_j


def _check_fc(c, name):
    dtype = torch.bfloat16 if name.endswith("bf16") else torch.float32
    tx, tW, jx, jW, jdt = _fc_operands(c, dtype)
    for t in (0, 1):
        got = prof_t.fc_step(name, tx, tW)(t)
        if "honest" in name:
            xp_t, xp_same, xp_j = _check_tanh_input(tx, jx, t, jdt)
            assert torch.equal(got, prof_t.fc_bmm(xp_t, tW))
            got = prof_t.fc_bmm(xp_same, tW)
            want = jnp.einsum("bk,bkn->bn", xp_j, jW, preferred_element_type=jnp.float32)
        else:
            factor = 1 + 1e-3 * _jt(t, jdt)
            assert prof_t.scale(t, dtype) == float(factor)
            xs = jx * factor
            want = j_pop_linear(xs, jW, interpret=True) if "pallas" in name else \
                jnp.einsum("bk,bkn->bn", xs, jW, preferred_element_type=jnp.float32)
        _fc_tol(name, got, want)


def _small_models(dtype):
    cd = "bfloat16" if dtype == torch.bfloat16 else "float32"
    return VirtualBNDQN(num_actions=NA, forward_impl="split", compute_dtype=cd), \
        JVBN(num_actions=NA, forward_impl="split", compute_dtype=cd)


def _check_conv_batch(c, dtype):
    tm, jm = _small_models(dtype)
    tparts, _ = tm.prepare_batch_params((torch.from_numpy(c.theta), c.tstats))
    jparts, _ = jm.prepare_batch_params((jnp.asarray(c.theta), c.jstats))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for t in (0, 1):
        got = prof_t.conv_batch_step(tparts, torch.from_numpy(c.obs), dtype)(t)
        x = (jnp.asarray(c.obs) + 1e-6 * _jt(t)).astype(jdt)
        h1 = jax.nn.relu(j_conv(jparts["conv1/w"], x, stride=4)).astype(jdt)
        want = jax.nn.relu(j_conv(jparts["conv2/w"], h1, stride=2))
        (_chain_close if dtype == torch.bfloat16 else _close)(got, want)


def _check_act_split(c, name):
    dtype = torch.bfloat16 if name == "act_new_bf16" else torch.float32
    tm, jm = _small_models(dtype)
    tparts, tst = tm.prepare_batch_params((torch.from_numpy(c.theta), c.tstats))
    jparts, jst = jm.prepare_batch_params((jnp.asarray(c.theta), c.jstats))
    obs = torch.from_numpy(c.obs)
    rel = BF16_SCORES if dtype == torch.bfloat16 else F32_SCORES
    compared = 0
    for t in (0, 1):
        o = obs + 1e-6 * t
        jo = jnp.asarray(c.obs) + 1e-6 * _jt(t)
        if name == "act_old":
            got = prof_t.act_old_step(tm, tparts, tst, obs)(t)
            want = jax.vmap(lambda p, oo, st: jm.act_parts(p, oo, None, st))(jparts, jo, jst)
        else:
            got = prof_t.act_step(tm, tparts, tst, obs)(t)
            want = jm.batch_act_parts(jparts, jo, None, jst)
        jscores = jm.batch_scores_parts(jparts, jo, jst)
        compared += _actions_agree(got, want, tm.batch_scores_parts(tparts, o, tst), jscores, _bound(jscores, rel))
    assert compared > 0


def _check_act_folded(c):
    tm = VirtualBNDQN(num_actions=NA, forward_impl="folded", compute_dtype="bfloat16")
    jm = JVBN(num_actions=NA, forward_impl="folded", compute_dtype="bfloat16")
    tparts, _ = tm.prepare_batch_params((torch.from_numpy(c.theta), c.tstats))
    jparts, _ = jm.prepare_batch_params((jnp.asarray(c.theta), c.jstats))
    obs = torch.from_numpy(c.obs)
    compared = 0
    for t in (0, 1):
        jo = jnp.asarray(c.obs) + 1e-6 * _jt(t)
        got = prof_t.act_step(tm, tparts, None, obs)(t)
        jscores = jm.batch_scores_folded(jparts, jo)
        compared += _actions_agree(got, jm.batch_act_parts(jparts, jo, None, None),
                                   tm.batch_scores_folded(tparts["__folded__"], obs + 1e-6 * t), jscores,
                                   _bound(jscores, BF16_SCORES))
    assert compared > 0


def _check_act_fused(c, name):
    one = name == "act_fused1"
    impl, cd, style = ("fused1", "bfloat16", "one") if one else ("fused", "float32", "two")
    tm = VirtualBNDQN(num_actions=NA, forward_impl=impl, compute_dtype=cd)
    jm = JVBN(num_actions=NA, forward_impl=impl, compute_dtype=cd)
    tops = tm.fuse_prepare(tm.prepare_parts(tm.unflatten(torch.from_numpy(c.theta))), c.tstats, style=style)
    jops = jm.fuse_prepare(jm.prepare_parts(jax.vmap(jm.unflatten)(jnp.asarray(c.theta))), c.jstats, style=style)
    obs = torch.from_numpy(c.obs)
    compared = 0
    for t in (0, 1):
        jo = jnp.asarray(c.obs) + 1e-6 * _jt(t)
        got = prof_t.act_fused_step(tm, tops, obs)(t)
        jscores = jm.batch_scores_fused(jops, jo, interpret=True)
        compared += _actions_agree(got, jnp.argmax(jscores, -1), tm.batch_scores_fused(tops, obs + 1e-6 * t),
                                   jscores, _fused_bound(jscores))
    assert compared > 0


def _large(c):
    tm = LargeDQN(num_actions=NA, compute_dtype="bfloat16", forward_impl="split")
    jm = jdqn.LargeDQN(num_actions=NA, compute_dtype="bfloat16", forward_impl="split")
    tparts = tm.prepare_parts(tm.unflatten(torch.from_numpy(c.theta_large)))
    jparts, _ = jm.prepare_batch_params((jnp.asarray(c.theta_large), None))
    return tm, jm, tparts, jparts


def _check_lg_conv(c, name):
    _, _, tparts, jparts = _large(c)
    x = {"lg_conv1": c.obs, "lg_conv2": c.h1, "lg_conv3": c.h2}[name]
    wname, stride = {"lg_conv1": ("conv1/w", 4), "lg_conv2": ("conv2/w", 2), "lg_conv3": ("conv3/w", 1)}[name]
    tx, jx = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(x).astype(jnp.bfloat16)
    for t in (0, 1):
        got = prof_t.lg_conv_step(tparts[wname], tx, stride)(t)
        _close(got, j_conv(jparts[wname], jx + _jt(t, jnp.bfloat16), stride=stride))


def _check_lg_convchain(c):
    _, _, tparts, jparts = _large(c)
    for t in (0, 1):
        got = prof_t.lg_convchain_step(tparts, torch.from_numpy(c.obs))(t)
        h = (jnp.asarray(c.obs) + 1e-6 * _jt(t)).astype(jnp.bfloat16)
        for nm, s in (("conv1/w", 4), ("conv2/w", 2), ("conv3/w", 1)):
            h = jax.nn.relu(j_conv(jparts[nm], h, stride=s)).astype(jnp.bfloat16)
        _chain_close(got, h)


def _check_lg_fc(c, name):
    _, _, tparts, jparts = _large(c)
    tx, jx = torch.from_numpy(c.xf).to(torch.bfloat16), jnp.asarray(c.xf).astype(jnp.bfloat16)
    for t in (0, 1):
        got = prof_t.lg_fc_step(name, tx, tparts["fc/w"])(t)
        xp_t, xp_same, xp_j = _check_tanh_input(tx, jx, t, jnp.bfloat16)
        fc = prof_t.population_linear if name == "lg_fc_pallas" else prof_t.fc_bmm
        assert torch.equal(got, fc(xp_t, tparts["fc/w"]))
        got = fc(xp_same, tparts["fc/w"])
        want = j_pop_linear(xp_j, jparts["fc/w"], interpret=True) if name == "lg_fc_pallas" else \
            jnp.einsum("bk,bkn->bn", xp_j, jparts["fc/w"], preferred_element_type=jnp.float32)
        if name == "lg_fc_xla":
            _close(got, want, rel_each=BF16_ULP)
        else:
            _close(got, want)


def _check_lg_forward(c, name):
    fused = name == "lg_forward_fused"
    impl = "fused" if fused else "auto"
    tm = LargeDQN(num_actions=NA, compute_dtype="bfloat16", forward_impl=impl)
    jm = jdqn.LargeDQN(num_actions=NA, compute_dtype="bfloat16", forward_impl=impl, fused_interpret=True)
    tparts, _ = tm.prepare_batch_params((torch.from_numpy(c.theta_large), None))
    jparts, _ = jm.prepare_batch_params((jnp.asarray(c.theta_large), None))
    assert ("__fused_lg__" in tparts) == ("__fused_lg__" in jparts) == fused  # 'auto' is split on the CPU
    obs = torch.from_numpy(c.obs)
    compared = 0
    for t in (0, 1):
        o, jo = obs + 1e-6 * t, jnp.asarray(c.obs) + 1e-6 * _jt(t)
        got = prof_t.act_step(tm, tparts, None, obs)(t)
        want = jm.batch_act_parts(jparts, jo, None)
        if fused:
            jscores = jm.batch_scores_fused(jparts["__fused_lg__"], jo, interpret=True)
            compared += _actions_agree(got, want, tm.batch_scores_fused(tparts["__fused_lg__"], o), jscores,
                                       _fused_bound(jscores))
        else:
            jscores = jm.batch_scores_parts(jparts, jo)
            compared += _actions_agree(got, want, tm.batch_scores_parts(tparts, o), jscores,
                                       _bound(jscores, BF16_SCORES))
    assert compared > 0


def _check_lg_stack_update(c):
    tf, jf = torch.from_numpy(c.frame), jnp.asarray(c.frame)
    for t in (0, 1):
        got = prof_t.lg_stack_update_step(tpre.stack_reset(tf), tf)(t)
        want = jpre.stack_step(jpre.stack_reset(jf), jf + 1e-6 * _jt(t))
        assert got.shape == (B, 84, 84, 4)
        np.testing.assert_array_equal(_np(got), _np(want))


def _check_lg_im2col1(c):
    for t in (0, 1):
        got = prof_t.lg_im2col1_step(torch.from_numpy(c.obs))(t)
        want = j_patches((jnp.asarray(c.obs) + 1e-6 * _jt(t)).astype(jnp.bfloat16), 8, 4, "SAME")
        np.testing.assert_array_equal(_np(got), _np(want))


def _check_lg_argmax(c):
    for t in (0, 1):
        got = prof_t.lg_argmax_step(torch.from_numpy(c.scores))(t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax((jnp.asarray(c.scores) + _jt(t))[:, 0, :], -1)))


CHECKS = {
    "rng_frames": _check_rng_frames, "palette": _check_palette,
    "preprocess_gray": lambda c: _check_preprocess(c, True), "preprocess": lambda c: _check_preprocess(c, False),
    **{n: functools.partial(_check_fc, name=n) for n in prof_t.SMALL_STAGES if n.startswith("fc_")},
    "conv_batch": lambda c: _check_conv_batch(c, torch.float32),
    "conv_batch_bf16": lambda c: _check_conv_batch(c, torch.bfloat16),
    **{n: functools.partial(_check_act_split, name=n) for n in ("act_old", "act_new", "act_new_bf16")},
    "act_folded_bf16": _check_act_folded,
    **{n: functools.partial(_check_act_fused, name=n) for n in ("act_fused1", "act_fused")},
    **{n: functools.partial(_check_lg_conv, name=n) for n in ("lg_conv1", "lg_conv2", "lg_conv3")},
    "lg_convchain": _check_lg_convchain,
    **{n: functools.partial(_check_lg_fc, name=n) for n in ("lg_fc_pallas", "lg_fc_xla")},
    **{n: functools.partial(_check_lg_forward, name=n) for n in ("lg_forward", "lg_forward_fused")},
    "lg_stack_update": _check_lg_stack_update, "lg_im2col1": _check_lg_im2col1, "lg_argmax": _check_lg_argmax,
}


def test_every_stage_has_a_parity_check():
    assert set(CHECKS) == set(prof_t.SMALL_STAGES) | set(prof_t.LARGE_STAGES)


@pytest.mark.parametrize("stage", prof_t.SMALL_STAGES + prof_t.LARGE_STAGES)
def test_stage_matches_jax(stage, cases, interpret):
    CHECKS[stage](cases)


# ------------------------------------------------------------- dry runs

def _jax_keys(name):
    return set(json.loads((RESULTS / name).read_text()))


def _jax_stages(*names):
    return set().union(*(json.loads((RESULTS / n).read_text())["stages_ms"] for n in names))


@pytest.fixture(scope="module")
def small_profile(tmp_path_factory):
    out = tmp_path_factory.mktemp("profile") / "small.json"
    torch.set_num_threads(1)
    art = prof_t.run(["--device", "cpu", "--B", "2", "--out", str(out)])
    return out, art


def test_profile_dry_run_keeps_the_jax_keys(small_profile):
    path, art = small_profile
    assert set(art) == _jax_keys("profile_stages_r04.json") | {"device"}
    assert json.loads(path.read_text()) == json.loads(json.dumps(art))
    want = _jax_stages("profile_stages_r03.json", "profile_stages_r04.json", "profile_stages_r04_b512.json")
    assert want <= set(art["stages_ms"]) and set(art["stages_ms"]) == want | set(prof_t.SMALL_STAGES)
    assert all(math.isfinite(v) for v in art["stages_ms"].values())
    assert all(art["notes"][k]["timing"] == "host clock (cpu)" for k in art["stages_ms"])
    assert all(art["notes"][k]["launches"] == {} for k in art["stages_ms"])  # the CPU runs no kernel
    for k in ("act_folded_bf16", "act_fused1", "act_fused"):
        assert 0 <= art["notes"][k]["action_match_vs_split"] <= 1
    assert art["device"]["card"] == "cpu"


def test_profile_large_dry_run_keeps_the_jax_keys(tmp_path):
    art = prof_t.run(["--device", "cpu", "--B", "2", "--model", "large", "--out", str(tmp_path / "large.json")])
    jax_art = json.loads((RESULTS / "profile_stages_r04_large.json").read_text())
    assert set(art) == set(jax_art) | {"device"}
    assert set(jax_art["stages_ms"]) <= set(art["stages_ms"]) == set(prof_t.LARGE_STAGES)
    assert set(jax_art["race_ms"]) <= set(art["race_ms"])
    assert art["in_situ_bench"] is None and "not measured" in art["notes"]["in_situ_bench"]
    eq = art["on_chip_equivalence"]
    assert set(jax_art["on_chip_equivalence"]) == set(eq) and eq["batches"] == prof_t.MATCH_BATCHES
    assert eq["mean_match"] == 1.0  # 'auto' is the split route on the CPU
    assert art["notes"]["lg_forward"]["route"] == "split" and art["notes"]["lg_forward_fused"]["route"] != "split"
    assert all(art["notes"][k]["launches"] == {} for k in list(art["stages_ms"]) + ["race_ms"])


def test_e2e_dry_run_keeps_the_jax_keys(tmp_path, monkeypatch):
    monkeypatch.setattr(e2e_t, "TABLE_COUNT", 3_000_000)
    art = e2e_t.main(["--device", "cpu", "--pop", "16", "--slots", "8", "--cutoff", "20", "--gens", "1",
                      "--out", str(tmp_path / "e2e.json")])
    jax_art = json.loads((RESULTS / "bench_e2e_r03.json").read_text())
    assert set(art) == set(jax_art) | {"device"}
    assert set(art["phase_s_per_generation"]) == set(jax_art["phase_s_per_generation"])
    assert math.isclose(sum(art["phase_s_per_generation"].values()), art["s_per_generation"], rel_tol=1e-9)
    assert art["platform"] == "cpu" and art["episodes_per_gen"] == 16 and "tunnel" not in art["note"]


def test_engine_dry_run_keeps_the_jax_keys(small_profile, tmp_path):
    art = eng_t.main(["--device", "cpu", "--batch", "8", "--staging", "--profile", str(small_profile[0]),
                      "--out", str(tmp_path / "engine.json")])
    assert set(art) == _jax_keys("engine_bench_r04.json") | {"device"}
    for backend in ("toy", "ale_stub"):
        assert set(art[backend]) == {"1", "2", "4"}
        assert len({r["resets"] for r in art[backend].values()}) == 1
    assert art["staging_uint8"]["platform"] == "cpu" and art["staging_uint8"]["bytes"] == 8 * 2 * 210 * 160
    dm = art["deployment_model"]
    assert set(dm) == set(json.loads((RESULTS / "engine_bench_r04.json").read_text())["deployment_model"])
    assert dm["device_capability_frames_per_s"] is None and "not measured" in dm["note"]


def test_engine_capability_comes_from_a_card_profile(tmp_path):
    """4·B frames over the default route's stage, naming the card."""
    prof = {"B": 256, "stages_ms": {"act_new": 0.5}, "device": {"card": "NVIDIA H100 80GB HBM3, 700.00 W"}}
    (tmp_path / "p.json").write_text(json.dumps(prof))
    dm = eng_t.deployment_model(str(tmp_path / "p.json"))
    assert dm["device_capability_frames_per_s"] == 4 * 256 / 0.5e-3
    assert dm["host_cores_needed_at_frames_per_core"]["500"] == round(4 * 256 / 0.5e-3 / 500)
    assert "NVIDIA H100" in dm["note"] and "act_new" in dm["note"]


def test_scaling_dry_run_keeps_the_jax_keys(tmp_path):
    """Two gloo ranks on the CPU, each rank's kernel counters reported
    (all 0 here: a CPU tensor runs the plain versions; chip_smoke.py phase 34
    requires K2 in every maze rank on the card)."""
    art = scal_t.main(["--device", "cpu", "--out", str(tmp_path / "s.json"), "--preset", "tiny"])
    jax_art = json.loads((RESULTS / "scaling_r05.json").read_text())
    assert set(art) == set(jax_art) | {"device"}
    for key in ("mesh_strong_scaling", "mesh_weak_scaling", "hostpod_emulation"):
        assert set(art[key]) == {"2"}
    for key in ("mesh_strong_scaling", "mesh_weak_scaling"):
        for n, r in art[key].items():
            assert len(r["launches_by_rank"]) == int(n)
    real = art["hostpod_real_2proc"]
    by_rank = [x for key in ("mesh_strong_scaling", "mesh_weak_scaling") for r in art[key].values()
               for x in r["launches_by_rank"]] + real["launches_by_rank"]
    assert all(x == {"population_linear": 0, "noise_gradient": 0} for x in by_rank)  # the CPU runs no kernel
    assert real["collective_calls_per_gen"] > 0 and real["collective_s_per_gen"] >= 0
    model = art["collective_cost_model"]
    assert set(model) == set(jax_art["collective_cost_model"])
    for name, row in model.items():
        assert row["gradient_psum_bytes"] == jax_art["collective_cost_model"][name]["gradient_psum_bytes"]
        assert not any("GBps" in k for k in row)
    assert art["analysis"]["card"] == "cpu" and art["analysis"]["cores"] >= 1


# --------------------------------------------------------------- engine

def test_engine_resets_match_jax():
    """The toy backend at batch 8, threads 1 and 2: both scripts'
    ``bench_backend`` count the same resets (100 steps: ToyCatch episodes
    outlast 60)."""
    eng_j = _script("bench_engine")
    got = eng_t.bench_backend("toy", "", batch=8, threads_list=(1, 2), steps=100)
    want = eng_j.bench_backend("toy", "", batch=8, threads_list=(1, 2), steps=100)
    assert {k: r["resets"] for k, r in got.items()} == {k: r["resets"] for k, r in want.items()}
    assert got["1"]["resets"] == got["2"]["resets"] > 0
