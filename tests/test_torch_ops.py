"""Parity of the port's ops (deep_neuroevolution_torch.ops) with the JAX
package's, on the CPU. The same numpy inputs, made from a seed, go through
both; tolerances are stated beside each comparison."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch import weights
from deep_neuroevolution_torch.models import VirtualBNDQN as TorchVBN
from deep_neuroevolution_torch.ops import fitness as tfit
from deep_neuroevolution_torch.ops import flat as tflat
from deep_neuroevolution_torch.ops import optim as topt
from deep_neuroevolution_torch.ops.noise import NoiseTable as TorchNoise
from deep_neuroevolution_tpu.models.batchnorm import VirtualBNDQN as JaxVBN
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops import flat as jflat
from deep_neuroevolution_tpu.ops import optim as jopt
from deep_neuroevolution_tpu.ops.noise import NoiseTable as JaxNoise


class TestNoiseTable:
    def test_from_seed_bit_exact(self):
        """Exact: both are RandomState(123).randn(count).astype(float32)."""
        t = TorchNoise.from_seed(count=200_000, device="cpu")
        j = JaxNoise.from_seed(count=200_000)
        np.testing.assert_array_equal(t.noise.numpy(), np.asarray(j.noise))

    def test_get_and_get_batch_exact(self):
        t = TorchNoise.from_seed(count=50_000, device="cpu")
        j = JaxNoise.from_seed(count=50_000)
        idxs = np.array([0, 7, 1023, 50_000 - 300], np.int32)  # unaligned, and one at the end
        np.testing.assert_array_equal(t.get(7, 300).numpy(), np.asarray(j.get(7, 300)))
        np.testing.assert_array_equal(
            t.get_batch(torch.from_numpy(idxs), 300).numpy(), np.asarray(j.get_batch(jnp.asarray(idxs), 300))
        )
        with pytest.raises(IndexError):
            t.get(50_000 - 299, 300)

    def test_sample_index_batch_range_and_generator(self):
        """Offsets cover [0, size − dim] unaligned, and come from the given
        generator only."""
        t = TorchNoise.from_seed(count=10_000, device="cpu")
        a = t.sample_index_batch(torch.Generator().manual_seed(5), 9_990, 4096)
        b = t.sample_index_batch(torch.Generator().manual_seed(5), 9_990, 4096)
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
        assert int(a.min()) >= 0 and int(a.max()) <= 10
        assert set(a.tolist()) == set(range(11))  # every offset, odd ones included


class TestFitness:
    def test_ranks_exact_with_ties(self):
        """Exact, ties included: both sorts are stable."""
        x = np.array([3.0, 1.0, 3.0, -2.0, 1.0, 1.0, 7.0, 3.0], np.float32)
        np.testing.assert_array_equal(
            tfit.compute_ranks(torch.from_numpy(x)).numpy(), np.asarray(jfit.compute_ranks(jnp.asarray(x)))
        )
        rs = np.random.RandomState(0)
        r2 = rs.randint(0, 5, size=(37, 2)).astype(np.float32)  # many ties
        np.testing.assert_array_equal(
            tfit.compute_centered_ranks(torch.from_numpy(r2)).numpy(),
            np.asarray(jfit.compute_centered_ranks(jnp.asarray(r2))),
        )

    @pytest.mark.parametrize("mode", ["centered_rank", "sign", "centered_sign_rank"])
    def test_process_returns_exact(self, mode):
        rs = np.random.RandomState(1)
        rets = rs.randint(-3, 4, size=(16, 2)).astype(np.float32)
        srets = np.sign(rets)
        t = tfit.process_returns(torch.from_numpy(rets), torch.from_numpy(srets), mode)
        j = jfit.process_returns(jnp.asarray(rets), jnp.asarray(srets), mode)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


class TestFlat:
    def test_specs_and_offsets_match(self):
        """The port's VBN-DQN θ layout is the JAX package's, name by name."""
        t, j = TorchVBN(num_actions=4), JaxVBN(num_actions=4)
        assert [(s.name, tuple(s.shape), s.init, s.std) for s in t.specs] == [
            (s.name, tuple(s.shape), s.init, s.std) for s in j.specs
        ]
        assert t.num_params == j.num_params == 1_004_852
        assert tflat.offsets(t.specs) == jflat.offsets(j.specs)

    def test_unflatten_exact(self):
        """Exact: static slices of the same vector."""
        t, j = TorchVBN(num_actions=4), JaxVBN(num_actions=4)
        theta = np.random.RandomState(2).randn(j.num_params).astype(np.float32)
        jparts = j.unflatten(jnp.asarray(theta))
        tparts = t.unflatten(weights.from_jax(theta, device="cpu"))
        for name, v in jparts.items():
            np.testing.assert_array_equal(tparts[name].numpy(), np.asarray(v))
        # a stacked [B, D] θ unflattens member by member
        tb = t.unflatten(torch.from_numpy(np.stack([theta, -theta])))
        np.testing.assert_array_equal(tb["fc/w"][1].numpy(), -np.asarray(jparts["fc/w"]))
        np.testing.assert_array_equal(tflat.flatten(tparts, t.specs).numpy(), theta)

    def test_from_jax_dict(self):
        j = JaxVBN(num_actions=4)
        theta = np.random.RandomState(3).randn(j.num_params).astype(np.float32)
        parts = {k: np.asarray(v) for k, v in j.unflatten(jnp.asarray(theta)).items()}
        tparts = weights.from_jax(parts, device="cpu")
        assert set(tparts) == set(parts)
        np.testing.assert_array_equal(tparts["conv2/w"].numpy(), parts["conv2/w"])

    def test_normc_columns(self):
        """normc: every column of a weight has L2 norm std (same rule as the
        JAX init; the two RNGs differ, so values are not compared)."""
        t = TorchVBN(num_actions=4)
        parts = t.unflatten(t.init_theta(torch.Generator().manual_seed(0)))
        norms = parts["out/w"].reshape(-1, 4).norm(dim=0)
        np.testing.assert_allclose(norms.numpy(), 1.0, rtol=1e-5)
        assert float(parts["fc/bn_b"].abs().max()) == 0.0


class TestOptim:
    @pytest.mark.parametrize("name", ["adam", "sgd"])
    def test_update_matches(self, name):
        """Two steps from the same θ and gradients; float32 elementwise
        math, so within 1e-6 relative."""
        rs = np.random.RandomState(4)
        theta = rs.randn(1000).astype(np.float32)
        gs = [rs.randn(1000).astype(np.float32) for _ in range(2)]
        jo, to = jopt.make_optimizer(name, stepsize=0.01), topt.make_optimizer(name, stepsize=0.01)
        js, ts = jo.init(1000), to.init(1000)
        jt, tt = jnp.asarray(theta), torch.from_numpy(theta)
        for g in gs:
            js, jt, jr = jo.update(js, jt, jnp.asarray(g))
            ts, tt, tr = to.update(ts, tt, torch.from_numpy(g))
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5)
