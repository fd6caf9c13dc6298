"""Parity of the port's preprocessing and VBN-DQN population forward with the
JAX package's, on the CPU, from the same numpy inputs and the same θ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.envs import preprocess as tpre
from deep_neuroevolution_torch.models import VirtualBNDQN as TorchVBN
from deep_neuroevolution_torch.models import core as tcore
from deep_neuroevolution_tpu.envs import preprocess as jpre
from deep_neuroevolution_tpu.models import core as jcore
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN


class TestPreprocess:
    def test_palette_exact(self):
        """Exact: the same NTSC table and the same float32 arithmetic."""
        np.testing.assert_array_equal(tpre.GRAYSCALE_PALETTE, jpre.GRAYSCALE_PALETTE)
        np.testing.assert_array_equal(tpre.GRAY_PALETTE_UINT8, jpre.GRAY_PALETTE_UINT8)
        np.testing.assert_array_equal(tpre._interp_matrix(210, 84), jpre._interp_matrix(210, 84))

    def test_resize_and_stack(self):
        """Within 1e-6: the resize is two float32 products whose sums may run
        in another order; the stack is data movement."""
        rs = np.random.RandomState(0)
        frames = rs.randint(0, 256, size=(3, 2, 210, 160)).astype(np.uint8)
        j = np.asarray(jpre.preprocess_gray_frames(jnp.asarray(frames), 84, 84))
        t = tpre.preprocess_gray_frames(torch.from_numpy(frames), 84, 84)
        assert t.shape == (3, 84, 84, 1)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-6)
        frames2 = rs.randint(0, 256, size=(3, 2, 210, 160)).astype(np.uint8)
        js = jpre.stack_step(jpre.stack_reset(jnp.asarray(j)),
                             jpre.preprocess_gray_frames(jnp.asarray(frames2), 84, 84))
        ts = tpre.stack_step(tpre.stack_reset(t), tpre.preprocess_gray_frames(torch.from_numpy(frames2)))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)


class TestConvPieces:
    @pytest.mark.parametrize("hw,k,s", [(84, 8, 4), (21, 4, 2), (11, 3, 1)])
    def test_extract_patches_exact(self, hw, k, s):
        """Exact: SAME padding with the extra element on the high side and
        (i, j, c) feature order are data movement."""
        x = np.random.RandomState(hw).randn(2, hw, hw, 3).astype(np.float32)
        j = np.asarray(jcore.extract_patches(jnp.asarray(x), k, s, "SAME"))
        t = tcore.extract_patches(torch.from_numpy(x), k, s)
        np.testing.assert_array_equal(t.numpy(), j)

    def test_batch_conv2d(self):
        """f32 within 1e-5: sums in another order."""
        rs = np.random.RandomState(1)
        w = rs.randn(3, 4, 4, 5, 6).astype(np.float32)
        x = rs.randn(3, 21, 21, 5).astype(np.float32)
        j = np.asarray(jcore.batch_conv2d(jnp.asarray(w), jnp.asarray(x), 2))
        t = tcore.batch_conv2d(torch.from_numpy(w), torch.from_numpy(x), 2)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-5)


def _vbn_inputs(B=4, R=16, seed=0):
    """θ stack [B, D] near a normc init, a reference batch and frames."""
    jm = JaxVBN(num_actions=4)
    base = np.asarray(jm.init_theta(jax.random.PRNGKey(seed)))
    rs = np.random.RandomState(seed)
    thetas = (base[None] + 0.02 * rs.randn(B, jm.num_params)).astype(np.float32)
    ref = rs.rand(R, 84, 84, 4).astype(np.float32)
    obs = rs.rand(B, 84, 84, 4).astype(np.float32)
    return thetas, ref, obs


def _jax_scores(model, thetas, ref, obs):
    stats = model.batch_ref_stats(jnp.asarray(thetas), jnp.asarray(ref))
    parts, stats = model.prepare_batch_params((jnp.asarray(thetas), stats))
    return stats, np.asarray(model.batch_scores_parts(parts, jnp.asarray(obs), stats))


def _torch_scores(model, thetas, ref, obs):
    th = weights.from_jax(thetas, device="cpu")
    stats = model.batch_ref_stats(th, torch.from_numpy(ref))
    parts, stats = model.prepare_batch_params((th, stats))
    return stats, model.batch_scores_parts(parts, torch.from_numpy(obs), stats).numpy()


def _assert_argmax(t_scores, j_scores, tie_gap):
    """Equal argmax, except where the JAX scores' top two are closer than
    ``tie_gap`` (reported, not failed)."""
    top2 = np.sort(j_scores, axis=-1)[:, -2:]
    near_tie = (top2[:, 1] - top2[:, 0]) < tie_gap
    if near_tie.any():
        print(f"near ties (top-two gap < {tie_gap}) in rows {np.nonzero(near_tie)[0].tolist()}")
    np.testing.assert_array_equal(t_scores.argmax(-1)[~near_tie], j_scores.argmax(-1)[~near_tie])


class TestVirtualBNDQN:
    def test_f32_ref_stats_and_forward(self):
        """B=4, full width: float32 scores within 1e-4, equal argmax except
        for a JAX top-two gap under 1e-5. The moments match within 1e-4
        relative (sums in another order)."""
        thetas, ref, obs = _vbn_inputs()
        jstats, js = _jax_scores(JaxVBN(num_actions=4), thetas, ref, obs)
        tstats, ts = _torch_scores(TorchVBN(num_actions=4), thetas, ref, obs)
        for jm, tm in zip(jstats.mean + jstats.inv_std, tstats.mean + tstats.inv_std):
            np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ts, js, rtol=0, atol=1e-4)
        _assert_argmax(ts, js, 1e-5)

    def test_actions_through_make_batch_act(self):
        thetas, ref, obs = _vbn_inputs(seed=1)
        tm = TorchVBN(num_actions=4)
        th = weights.from_jax(thetas, device="cpu")
        stats = tm.batch_ref_stats(th, torch.from_numpy(ref))
        act = tm.make_batch_act()
        acts = act(act.prepare((th, stats)), torch.from_numpy(obs))
        _, ts = _torch_scores(tm, thetas, ref, obs)
        np.testing.assert_array_equal(acts.numpy(), ts.argmax(-1))

    def test_bf16(self):
        """compute_dtype bfloat16 in both packages: scores within atol 0.05
        (the bf16 bar of the JAX package's own kernels), equal argmax except
        for near ties."""
        thetas, ref, obs = _vbn_inputs(seed=2)
        _, js = _jax_scores(JaxVBN(num_actions=4, compute_dtype="bfloat16"), thetas, ref, obs)
        _, ts = _torch_scores(TorchVBN(num_actions=4, compute_dtype="bfloat16"), thetas, ref, obs)
        np.testing.assert_allclose(ts, js, rtol=0, atol=0.05)
        _assert_argmax(ts, js, 0.05)

    def test_ref_stats_chunking(self, monkeypatch):
        """Member chunks of the reference-batch pass give the stats of one
        chunk, within 1e-5 relative: a batched product may block its sums
        differently for another member count."""
        thetas, ref, _ = _vbn_inputs(B=5, R=4, seed=3)
        tm = TorchVBN(num_actions=4)
        th = torch.from_numpy(thetas)
        whole = tm.batch_ref_stats(th, torch.from_numpy(ref))
        monkeypatch.setattr(TorchVBN, "REF_STATS_CHUNK", 2)
        chunked = tm.batch_ref_stats(th, torch.from_numpy(ref))
        for a, b in zip(whole.mean + whole.inv_std, chunked.mean + chunked.inv_std):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
