"""The DQN family's fields (``nonlin_type``, ``in_hw``, ``in_ch``,
``out_std``), BNDQN (ModelBN) and the chunked prepare in the port against
the JAX package, on the CPU, from numpy inputs made from a seed.

Tolerances, fixed before the comparison:

* float32 forwards of SmallDQN, LargeDQN and VirtualBNDQN, every
  nonlinearity: scores within 1e-5·max|score| plus rtol 1e-5 (sums in
  another order; the VBN-DQN's moments amplify them, so 1e-4 there, as
  tests/test_torch_models.py holds it), equal argmax but at a top-two gap
  under that tolerance;
* BNDQN: scores within 1e-4·max|score| (its moments divide by a small
  spatial spread), equal actions but at such a near tie;
* specs, ``num_params``, policy files and the chunked prepare: exact.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import models as tmodels
from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.utils import checkpoint as tckpt
from deep_neuroevolution_torch.utils import config as tconfig
from deep_neuroevolution_tpu import models as jmodels
from deep_neuroevolution_tpu.models import batchnorm as jbn
from deep_neuroevolution_tpu.utils import checkpoint as jckpt
from deep_neuroevolution_tpu.utils import config as jconfig

ROOT = Path(__file__).resolve().parent.parent
NONLINS = ("relu", "tanh", "lrelu", "elu")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_cls(name):
    return jbn.BNDQN if name == "BNDQN" else getattr(jmodels, name, None) or jmodels.get_model(name)


def _inputs(jm, B, seed, hw=84, ch=4, R=0):
    """θ stack near a normc init, frames (and a reference batch of R)."""
    rs = np.random.RandomState(seed)
    base = np.asarray(jm.init_theta(jax.random.PRNGKey(seed)))
    thetas = (base[None] + 0.02 * rs.randn(B, jm.num_params)).astype(np.float32)
    obs = rs.rand(B, hw, hw, ch).astype(np.float32)
    ref = rs.rand(R, hw, hw, ch).astype(np.float32) if R else None
    return thetas, obs, ref


def _scores(jm, tm, thetas, obs, ref=None):
    """Both packages' split-route scores (VBN stats from ``ref``)."""
    jth, tth = jnp.asarray(thetas), weights.from_jax(thetas, device="cpu")
    jctx = tctx = None
    if ref is not None:
        jctx = jm.batch_ref_stats(jth, jnp.asarray(ref))
        tctx = tm.batch_ref_stats(tth, torch.from_numpy(ref))
    jparts, jctx = jm.prepare_batch_params((jth, jctx))
    tparts, tctx = tm.prepare_batch_params((tth, tctx))
    j = np.asarray(jm.batch_scores_parts(jparts, jnp.asarray(obs), jctx))
    return j, tm.batch_scores_parts(tparts, torch.from_numpy(obs), tctx).numpy()


def _assert_close(t, j, rel):
    tol = rel * np.abs(j).max()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=tol)
    top2 = np.sort(j, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) >= 2 * tol
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear])


# ------------------------------------------------------------------ forwards


@pytest.mark.parametrize("nonlin", NONLINS)
@pytest.mark.parametrize("name", ("SmallDQN", "LargeDQN", "VirtualBNDQN"))
def test_every_nonlinearity_against_jax(name, nonlin):
    """B=2 members at full width, the split route (K1 on a card)."""
    kw = dict(num_actions=4, nonlin_type=nonlin)
    jkw = dict(kw, matvec_impl="xla", **({"forward_impl": "split"} if name == "LargeDQN" else {}))
    jm, tm = _jax_cls(name)(**jkw), getattr(tmodels, name)(**kw)
    thetas, obs, ref = _inputs(jm, 2, NONLINS.index(nonlin), R=4 if name == "VirtualBNDQN" else 0)
    j, t = _scores(jm, tm, thetas, obs, ref)
    _assert_close(t, j, 1e-4 if name == "VirtualBNDQN" else 1e-5)


@pytest.mark.parametrize("name", ("SmallDQN", "LargeDQN", "VirtualBNDQN", "BNDQN"))
def test_input_size_and_out_std_fields(name):
    """in_hw=64, in_ch=3 and out_std 0.05: the same specs (out/w's normc
    scale among them) and num_params; a tanh SmallDQN forward at that size
    against the JAX one."""
    kw = dict(num_actions=5, in_hw=64, in_ch=3, out_std=0.05)
    jm, tm = _jax_cls(name)(**kw), getattr(tmodels, name)(**kw)
    assert [(s.name, s.shape, s.init, s.std) for s in tm.specs] == [
        (s.name, s.shape, s.init, s.std) for s in jm.specs]
    assert tm.num_params == jm.num_params
    assert next(s.std for s in tm.specs if s.name == "out/w") == 0.05
    if name == "SmallDQN":
        jm, tm = (cls(nonlin_type="tanh", **kw) for cls in (jmodels.SmallDQN, tmodels.SmallDQN))
        thetas, obs, _ = _inputs(jm, 2, 5, hw=64, ch=3)
        j, t = _scores(jm, tm, thetas, obs)
        _assert_close(t, j, 1e-5)


def _bn_scores(jm, thetas, obs, monkeypatch):
    """The JAX BNDQN's batch act (a vmap of ``act_parts``) with argmax left
    out: its scores."""
    with monkeypatch.context() as m:
        m.setattr(jbn.jnp, "argmax", lambda x, *a, **k: x)
        act = jm.make_batch_act()
        return np.asarray(act(act.prepare((jnp.asarray(thetas), None)), jnp.asarray(obs), None))


@pytest.mark.parametrize("affine", ("bias", "full"))
@pytest.mark.parametrize("nonlin", ("relu", "elu"))
def test_bndqn_against_jax(affine, nonlin, monkeypatch):
    """Live moments per member: each conv's over its spatial axes, the fc's
    over its features (a batch of one). B=3; the registry's ModelBN."""
    kw = dict(num_actions=4, affine=affine, nonlin_type=nonlin)
    jm, tm = jbn.BNDQN(**kw), tmodels.get_model("ModelBN")(**kw)
    assert type(tm) is tmodels.BNDQN and not tm.needs_ref_batch
    thetas, obs, _ = _inputs(jm, 3, 11)
    rs = np.random.RandomState(1)
    thetas += (0.1 * rs.randn(*thetas.shape)).astype(np.float32)  # non-zero biases and gains
    j = _bn_scores(jm, thetas, obs, monkeypatch)
    act = jm.make_batch_act()
    jact = np.asarray(act(act.prepare((jnp.asarray(thetas), None)), jnp.asarray(obs), None))
    tact_fn = tm.make_batch_act()
    tth = weights.from_jax(thetas, device="cpu")
    tparts, _ = tm.prepare_batch_params((tth, None))
    t = tm.batch_scores_parts(tparts, torch.from_numpy(obs)).numpy()
    _assert_close(t, j, 1e-4)
    tact = tact_fn(tact_fn.prepare((tth, None)), torch.from_numpy(obs)).numpy()
    np.testing.assert_array_equal(tact, t.argmax(-1))
    np.testing.assert_array_equal(jact, j.argmax(-1))


def test_bndqn_has_one_route():
    with pytest.raises(ValueError, match="one route"):
        tmodels.BNDQN(num_actions=4, forward_impl="fused1")


# -------------------------------------------------------------------- routes


@pytest.mark.parametrize("nonlin", ("tanh", "elu"))
def test_forced_fused_route_on_non_relu_raises(nonlin):
    """As in the JAX package (an AssertionError when its route is chosen),
    a forced fused route on a non-relu DQN raises; the port raises when the
    model is built. 'auto' takes the split route. The JAX package's
    VirtualBNDQN does not check (its kernels apply relu whatever
    nonlin_type says); the port's raises too."""
    jm = jmodels.SmallDQN(num_actions=4, nonlin_type=nonlin, conv_impl="fused", fused_interpret=True)
    thetas, obs, _ = _inputs(jmodels.SmallDQN(num_actions=4), 1, 0)
    with pytest.raises(AssertionError):
        jm.batch_scores_parts(jm.prepare_batch_params((jnp.asarray(thetas), None))[0], jnp.asarray(obs))
    jl = jmodels.LargeDQN(num_actions=4, nonlin_type=nonlin, forward_impl="fused")
    with pytest.raises(AssertionError):
        jl.prepare_batch_params((jnp.zeros((1, jl.num_params)), None))
    with pytest.raises(ValueError, match="relu on 84×84×4"):
        tmodels.SmallDQN(num_actions=4, nonlin_type=nonlin, conv_impl="fused")
    with pytest.raises(ValueError, match="relu on 84×84×4"):
        tmodels.LargeDQN(num_actions=4, nonlin_type=nonlin, forward_impl="fused")
    for impl in ("fused", "fused1"):
        with pytest.raises(ValueError, match="relu on 84×84×4"):
            tmodels.VirtualBNDQN(num_actions=4, nonlin_type=nonlin, forward_impl=impl)
    with pytest.raises(ValueError, match="relu on 84×84×4"):
        tmodels.LargeDQN(num_actions=4, in_ch=3, forward_impl="fused")
    # 'auto' on a card: the split route (K1) for these, K3 for the relu LargeDQN
    card = torch.device("cuda")
    assert not tmodels.LargeDQN(num_actions=4, nonlin_type=nonlin)._use_whole_fused(card)
    assert not tmodels.LargeDQN(num_actions=4, in_hw=64)._use_whole_fused(card)
    assert tmodels.LargeDQN(num_actions=4)._use_whole_fused(card)


# ----------------------------------------------------------- chunked prepare


def _leaves(parts, prefix=""):
    """Nested prepared parts as {path: tensor}."""
    out = {}
    for k, v in parts.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


@pytest.mark.parametrize("name", ("LargeDQN", "VirtualBNDQN"))
def test_chunked_prepare_equals_the_whole(name):
    """``prepare_batch_params_chunked`` (B=5, chunk 2) equals the whole
    prepare bit for bit, on the split route (bf16) and on the VBN-DQN's
    folded route (its stats sliced alongside); the JAX package's chunked
    prepare of the same θ gives the same parts."""
    kw = dict(num_actions=4, compute_dtype="bfloat16")
    tm = getattr(tmodels, name)(**kw, **({"forward_impl": "folded"} if name == "VirtualBNDQN" else {}))
    jm = _jax_cls(name)(**kw)
    thetas, _, ref = _inputs(jm, 5, 3, R=2)
    th = weights.from_jax(thetas, device="cpu")
    ctx = tm.batch_ref_stats(th, torch.from_numpy(ref)) if tm.needs_ref_batch else None
    whole, wctx = tm.prepare_batch_params((th, ctx))
    chunked, cctx = tm.prepare_batch_params_chunked((th, ctx), 2)
    assert cctx is wctx
    w_leaves, c_leaves = _leaves(whole), _leaves(chunked)
    assert w_leaves.keys() == c_leaves.keys() and len(w_leaves) > 5
    for k, v in w_leaves.items():
        assert c_leaves[k].dtype == v.dtype and torch.equal(c_leaves[k], v), k
    if name == "LargeDQN":  # the split parts against the JAX package's chunked prepare
        jparts, _ = jm.prepare_batch_params_chunked((jnp.asarray(thetas), None), 2)
        for k, v in jparts.items():
            np.testing.assert_array_equal(chunked[k].float().numpy(), np.asarray(v.astype(jnp.float32)))
    assert tm.prepare_batch_params_chunked((th, ctx), 8)[0].keys() == whole.keys()


# ------------------------------------------------------- loader, policy files


def _frostbite_ga():
    return json.loads((ROOT / "configurations" / "frostbite_ga.json").read_text())


def test_loader_maps_ac_init_std_to_out_std():
    """No shipped file names ac_init_std: frostbite_ga.json's experiment with
    ac_init_std 0.05 builds a SmallDQN with out_std 0.05 in both loaders."""
    for path in (ROOT / "configurations").glob("*.json"):
        assert "ac_init_std" not in path.read_text(), path.name
    exp = _frostbite_ga()
    exp["policy"]["args"]["ac_init_std"] = 0.05
    over = {"noise_size": 2_000_000}
    jtr = jconfig.load_experiment(exp, algo="ga", overrides=over)
    jtr.env.close()
    ttr = tconfig.load_experiment(exp, algo="ga", overrides=over, device="cpu")
    ttr.close()
    assert ttr.model.out_std == jtr.model.out_std == 0.05
    assert ttr.model.num_params == jtr.model.num_params


FIELD_CASES = {
    "SmallDQN": dict(num_actions=5, nonlin_type="elu", in_hw=64, in_ch=3, out_std=0.05),
    "LargeDQN": dict(num_actions=4, nonlin_type="tanh", out_std=0.2),
    "VirtualBNDQN": dict(num_actions=4, nonlin_type="lrelu", in_hw=72, affine="full", out_std=0.5),
    "BNDQN": dict(num_actions=3, nonlin_type="tanh", in_ch=2),
}


@pytest.mark.parametrize("name", sorted(FIELD_CASES))
def test_policy_files_with_fields_cross_both_ways(name, tmp_path):
    """A policy file with non-default fields, written by each package and
    read by the other: the same class, the same fields, the same θ."""
    kw = FIELD_CASES[name]
    jm, tm = _jax_cls(name)(**kw), getattr(tmodels, name)(**kw)
    theta = np.random.RandomState(0).randn(jm.num_params).astype(np.float32)
    jpath, tpath = str(tmp_path / "j.pkl"), str(tmp_path / "t.pkl")
    jckpt.save_policy_snapshot(jpath, jm, jnp.asarray(theta))
    model, t, _ = tckpt.load_policy_snapshot(jpath, device="cpu")
    assert model == tm and np.array_equal(t.numpy(), theta)
    tckpt.save_policy_snapshot(tpath, tm, torch.from_numpy(theta))
    jmodel, jt, _ = jckpt.load_policy_snapshot(tpath)
    assert type(jmodel) is type(jm) and dataclasses.asdict(jmodel) == dataclasses.asdict(jm)
    assert np.array_equal(np.asarray(jt), theta)
