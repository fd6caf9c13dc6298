"""The port's two kernels, K1 (population_linear) and K2 (noise_gradient).

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX package's Pallas kernels (run in interpret mode, as
tests/test_pallas.py runs them) and against its XLA paths. The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py holds them
against the plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.device import NoCudaDevice
from deep_neuroevolution_torch.models import core as tcore
from deep_neuroevolution_torch.ops import _cuda_build
from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
from deep_neuroevolution_torch.ops.population_linear import population_linear
from deep_neuroevolution_tpu.models import core as jcore
from deep_neuroevolution_tpu.ops import fitness as jfit
from deep_neuroevolution_tpu.ops.pallas_forward import population_linear as jax_population_linear
from deep_neuroevolution_tpu.ops.pallas_kernels import GRANULE, gradient_from_noise_pallas


def _k1_inputs(B, K, N, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(B, K).astype(np.float32), rs.randn(B, K, N).astype(np.float32)


class TestPopulationLinear:
    @pytest.mark.parametrize("shape", [(4, 96, 64), (3, 200, 24)])
    def test_plain_matches_pallas_and_xla(self, shape):
        """f32, rtol 1e-5: the sums differ only in order."""
        x, W = _k1_inputs(*shape)
        ours = population_linear(torch.from_numpy(x), torch.from_numpy(W)).numpy()
        pallas = np.asarray(jax_population_linear(jnp.asarray(x), jnp.asarray(W), interpret=True))
        xla = np.asarray(jcore.pop_matvec(jnp.asarray(x), jnp.asarray(W), impl="xla"))
        np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ours, xla, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tcore.pop_matvec(torch.from_numpy(x), torch.from_numpy(W)).numpy(), xla,
                                   rtol=1e-5, atol=1e-5)

    def test_bf16_inputs_sum_in_f32(self):
        """bf16 x and W: products of bf16 values are exact in f32 and summed
        in f32 in both packages, so rtol 1e-5 holds here too."""
        x, W = _k1_inputs(4, 96, 64, seed=1)
        xb, Wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(W).bfloat16()
        ours = population_linear(xb, Wb)
        assert ours.dtype == torch.float32
        ref = jcore.pop_matvec(jnp.asarray(x, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16), impl="xla")
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_rejects_what_the_kernel_does_not_take(self):
        x, W = (torch.from_numpy(a) for a in _k1_inputs(2, 8, 4))
        with pytest.raises(TypeError):
            population_linear(x.bfloat16(), W)
        with pytest.raises(ValueError):
            population_linear(x, W[:, :4])
        with pytest.raises(ValueError):
            population_linear(x, W.transpose(1, 2).contiguous().transpose(1, 2))
        with pytest.raises(ValueError):  # neither cuda nor cpu
            population_linear(x.to("meta"), W.to("meta"))


def _golden(table, idxs, w, dim):
    return sum(w[i] * table[idxs[i] : idxs[i] + dim].astype(np.float64) for i in range(len(idxs)))


class TestNoiseGradient:
    def test_plain_matches_pallas_on_aligned_offsets(self):
        """Within 1e-5 of max|g|: float32 sums in another order."""
        rs = np.random.RandomState(0)
        N, dim, B = 120_000, 5000, 23
        table = rs.randn(N).astype(np.float32)
        idxs = (rs.randint(0, (N - 8 * 1024) // GRANULE, B) * GRANULE).astype(np.int32)
        w = rs.randn(B).astype(np.float32)
        pallas = np.asarray(
            gradient_from_noise_pallas(jnp.asarray(table), jnp.asarray(idxs), jnp.asarray(w), dim, 2048, True)
        )
        ours = noise_gradient(torch.from_numpy(table), torch.from_numpy(idxs), torch.from_numpy(w), dim).numpy()
        np.testing.assert_allclose(ours, pallas, rtol=0, atol=1e-5 * np.abs(pallas).max())

    def test_plain_matches_xla_on_unaligned_offsets(self):
        rs = np.random.RandomState(1)
        N, dim, B = 50_000, 3001, 300
        table = rs.randn(N).astype(np.float32)
        idxs = rs.randint(0, N - dim + 1, B).astype(np.int32)
        idxs[:3] = [N - dim, 1, 12_345]  # the last valid offset, odd offsets
        w = rs.randn(B).astype(np.float32)
        xla = np.asarray(jfit.gradient_from_noise(jnp.asarray(table), jnp.asarray(idxs), jnp.asarray(w), dim, 64))
        ours = noise_gradient(torch.from_numpy(table), torch.from_numpy(idxs), torch.from_numpy(w), dim).numpy()
        tol = 1e-5 * np.abs(xla).max()
        np.testing.assert_allclose(ours, xla, rtol=0, atol=tol)
        np.testing.assert_allclose(ours, _golden(table, idxs, w, dim), rtol=0, atol=tol)

    def test_rejects_out_of_range_and_wrong_types(self):
        table = torch.randn(1000)
        w = torch.ones(2)
        with pytest.raises(IndexError):  # one past the end
            noise_gradient(table, torch.tensor([0, 901], dtype=torch.int32), w, 100)
        with pytest.raises(IndexError):
            noise_gradient(table, torch.tensor([-1, 0], dtype=torch.int32), w, 100)
        with pytest.raises(TypeError):
            noise_gradient(table, torch.tensor([0, 1]), w, 100)  # int64 offsets
        with pytest.raises(TypeError):
            noise_gradient(table.double(), torch.tensor([0, 1], dtype=torch.int32), w, 100)
        with pytest.raises(ValueError):
            noise_gradient(table.to("meta"), torch.zeros(0, dtype=torch.int32, device="meta"),
                           torch.zeros(0, device="meta"), 100)
        # the last slice may end exactly at the table's last element
        g = noise_gradient(table, torch.tensor([0, 900], dtype=torch.int32), w, 100)
        torch.testing.assert_close(g, table[:100] + table[900:])


class TestNoCuda:
    def test_kernel_library_needs_a_card(self, monkeypatch):
        """Asking for the CUDA kernels without a CUDA device raises the
        package's error; it never builds or falls back."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _cuda_build.load.cache_clear()
        with pytest.raises(NoCudaDevice, match="no CUDA device"):
            _cuda_build.load()
        _cuda_build.load.cache_clear()
