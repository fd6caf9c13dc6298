"""Noise sources: the shared Gaussian table and its counter-based stand-in.

The counterpart of the JAX package's ops/noise.py. The reference
(es_distributed/es.py:51-67) draws 250M standard normals with
``np.random.RandomState(123).randn`` and converts them to float32;
``NoiseTable.from_seed`` does exactly that, so the table is bit-identical to
the JAX package's. Perturbations are start offsets into the table: row ``i``
is ``noise[i : i + dim]``.

Two more sources follow the JAX package's threefry streams (its
``jax_threefry_partitionable`` scheme, the default since jax 0.5):

* ``NoiseTable.from_key(key, count)``: ``jax.random.normal(key, (count,))``,
  a table built on the device in chunks instead of on the host;
* ``VirtualNoise``: no table; row ``i`` is ``normal(fold_in(key, i),
  (dim,))``, regenerated wherever it is read. Indices are opaque stream ids.

Both are written in plain torch integer and float ops (``threefry2x32``,
``normals``), the same code on the CPU and on the card: int64 holding
32-bit words, masked after every add. Element ``j`` of ``bits(key, n)`` is
``x0 ^ x1`` of threefry2x32 on the counter ``(j >> 32, j & 0xffffffff)``;
``fold_in(key, d)`` is threefry2x32 of ``(0, d)``; a normal is √2·erfinv(u),
u = 2·f − (1 − 2⁻²⁴) clamped below at −(1 − 2⁻²⁴), f = bits >> 9 read as
the mantissa of a float in [1, 2) minus 1, and erfinv XLA's single-precision
polynomial (Giles' two 9-term sets, split at w = −log1p(−u²) < 5), each
float32 operation rounded as there and each polynomial step one fused
multiply-add, as XLA's CPU code computes it; log1p is taken in float64 and
rounded once. The bits are the JAX package's bit for bit; the normals agree
within 4.8e-7 (over 2²⁰ draws about 1% differ, by up to three float32 ulps
where |x| < 1, where XLA's float32 log1p rounds otherwise;
tests/test_torch_noise_sources.py).

Offsets into a table are **unaligned**: ``sample_index_batch`` draws
uniformly over every valid start ``[0, size - dim]``, as the reference does.
The JAX package quantizes offsets to 1024 when its Pallas gradient is on
(``use_pallas_grad``), because Mosaic needs aligned DMA offsets; the port's
gradient kernel (csrc/noise_gradient.cu) takes any offset, so that
alignment is not carried over.

Index draws use an explicit CPU ``torch.Generator``, never the global RNG.

Both sources share ``size``, ``device``, ``get_batch`` and
``sample_index_batch``, and the trainers pass the source object itself.
``noise_rows`` and ``noise_row`` (the JAX package's noise.py:150-180) also
take a bare ``[count]`` table tensor; the JAX package's
``noise_source_size`` and ``sample_source_idxs`` are the sources' ``size``
and ``sample_index_batch`` here. A table's rows clamp an offset to the last
valid start, as ``lax.dynamic_slice`` clamps it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device

DEFAULT_COUNT = 250_000_000  # reference: es_distributed/es.py:55
DEFAULT_SEED = 123  # reference: es_distributed/es.py:54

# ------------------------------------------------------------ threefry2x32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_CHUNK = 1 << 23  # elements generated a pass: a few int64 temporaries of 64 MB

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it, with 64-bit
    types off: the seed modulo 2³² is the low word, the high word 0."""
    return 0, int(seed) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``). Keys are
    ints or int64 tensors, counters int64 tensors; all hold 32-bit words
    and broadcast together. Returns the two output words as int64."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)`` for one integer ``data``."""
    y0, y1 = fold_in_batch(key, torch.tensor([int(data)]))
    return int(y0[0]), int(y1[0])


def fold_in_batch(key: Key, data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The keys ``fold_in(key, d)`` for every ``d`` of ``data`` (taken
    modulo 2³², as ``jnp.uint32`` takes it), as two int64 tensors."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def _counter_bits(k0, k1, start: int, stop: int, device) -> torch.Tensor:
    """Elements ``[start, stop)`` of ``bits(key, ·)`` for keys ``k0``, ``k1``
    (ints, or int64 tensors ``[R, 1]`` for R streams)."""
    j = torch.arange(start, stop, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, j >> 32, j & _M32)
    return y0 ^ y1


def bits(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` (uint32) as int64 in ``[0, 2³²)``, on
    ``device`` (default cuda)."""
    return _counter_bits(key[0], key[1], 0, n, resolve_device(device))


_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))  # uniform's lower end, −(1 − 2⁻²⁴)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# XLA's ErfInv32 coefficients (Giles), highest degree first
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erfinv on float32 ``x`` in (−1, 1)."""
    w = torch.log1p((-x * x).double()).float().neg_()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    w64 = w.double()
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0]).float()
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        # one fused multiply-add a step, as XLA compiles it: p·w is exact
        # in float64, so the sum rounds once (but on a float64 tie)
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b))).double()
        p = torch.addcmul(c, p.double(), w64).float()
    return p * x


def normals(b: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s float32 draws from its 32-bit words ``b``."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp_min(f * 2.0 + _LO, _LO)
    return _erfinv(u) * _SQRT2


def _fill_normals(out: torch.Tensor, k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``out[r] = normal(key_r, (dim,))`` for the keys ``(k0[r], k1[r])``,
    ``out`` a float32 ``[R, dim]``, at most ``_CHUNK`` elements a pass."""
    R, dim = out.shape
    if R == 0 or dim == 0:
        return out
    cols = min(dim, _CHUNK)
    rows = max(1, _CHUNK // cols)
    k0, k1 = k0.to(out.device)[:, None], k1.to(out.device)[:, None]
    for r in range(0, R, rows):
        for c in range(0, dim, cols):
            stop = min(dim, c + cols)
            out[r : r + rows, c:stop] = normals(_counter_bits(k0[r : r + rows], k1[r : r + rows], c, stop, out.device))
    return out


def normal(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.normal(key, (n,), float32)``, built in chunks on ``device``
    (default cuda)."""
    out = torch.empty((1, int(n)), dtype=torch.float32, device=resolve_device(device))
    return _fill_normals(out, torch.tensor([key[0]]), torch.tensor([key[1]]))[0]


# ------------------------------------------------------------------ sources


@dataclasses.dataclass(frozen=True)
class NoiseTable:
    """Device-resident shared noise table."""

    noise: torch.Tensor  # [count] float32

    @classmethod
    def from_seed(
        cls,
        count: int = DEFAULT_COUNT,
        seed: int = DEFAULT_SEED,
        device: Optional[torch.device] = None,
    ) -> "NoiseTable":
        """The reference's table: ``RandomState(seed).randn(count)`` cast to
        float32 (es.py:60). At the default count this is a 2 GB float64
        array on the host for a moment; callers that need less pass a
        smaller ``count``."""
        host = np.random.RandomState(seed).randn(count).astype(np.float32)
        return cls(torch.from_numpy(host).to(device or "cpu"))

    @classmethod
    def from_key(cls, key: Key, count: int = DEFAULT_COUNT, device=None) -> "NoiseTable":
        """The JAX package's device-built table, ``jax.random.normal(key,
        (count,))`` (noise.py:64), generated on ``device`` (default cuda) in
        chunks; not the reference's RandomState stream."""
        return cls(normal(key, count, device))

    @property
    def size(self) -> int:
        return int(self.noise.shape[0])

    @property
    def device(self) -> torch.device:
        return self.noise.device

    def to(self, device) -> "NoiseTable":
        return self if self.noise.device == torch.device(device) else NoiseTable(self.noise.to(device))

    def get(self, i: int, dim: int) -> torch.Tensor:
        """``noise[i : i + dim]`` (a view)."""
        i = int(i)
        if i < 0 or i + dim > self.size:
            raise IndexError(f"noise row [{i}, {i + dim}) outside table of {self.size}")
        return self.noise[i : i + dim]

    def get_batch(self, idxs: torch.Tensor, dim: int) -> torch.Tensor:
        """Stacked rows ``[B, dim]`` for start offsets ``idxs [B]``, each
        clamped into ``[0, size - dim]`` (``lax.dynamic_slice``'s rule)."""
        if self.size < dim:
            raise ValueError(f"noise table ({self.size}) smaller than dim ({dim})")
        rows = self.noise.as_strided((self.size - dim + 1, dim), (1, 1))  # every row, no copy
        return rows[torch.as_tensor(idxs).to(device=self.noise.device, dtype=torch.int64).clamp(0, self.size - dim)]

    def sample_index_batch(self, gen: torch.Generator, dim: int, n: int) -> torch.Tensor:
        """``n`` start offsets, uniform over ``[0, size - dim]`` inclusive
        (es.py:66-67), as int32 on the CPU."""
        return _sample_offsets(self.size, gen, dim, n)


@dataclasses.dataclass(frozen=True)
class VirtualNoise:
    """Counter-based noise source with the NoiseTable interface (the JAX
    package's noise.py:98-145): row ``i`` is ``normal(fold_in(key, i),
    (dim,))``, generated on ``device`` when read: a device the caller
    names (``None`` is cuda, as everywhere in the port). ``count`` bounds
    the sampled ids, as a table's length bounds its offsets."""

    key: Key
    count: int = DEFAULT_COUNT
    device: torch.device = dataclasses.field(kw_only=True)

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    @classmethod
    def from_seed(cls, count: int = DEFAULT_COUNT, seed: int = DEFAULT_SEED, device=None) -> "VirtualNoise":
        """The source of ``PRNGKey(seed)``, generating on ``device`` (default cuda)."""
        return cls(prng_key(seed), int(count), device=device)

    @property
    def size(self) -> int:
        return self.count

    def to(self, device) -> "VirtualNoise":
        return dataclasses.replace(self, device=device)

    def get(self, i: int, dim: int) -> torch.Tensor:
        """Row ``i`` ``[dim]``."""
        return self.get_batch(torch.tensor([int(i)]), dim)[0]

    def get_batch(self, idxs: torch.Tensor, dim: int) -> torch.Tensor:
        """Rows ``[B, dim]`` for stream ids ``idxs [B]``."""
        k0, k1 = fold_in_batch(self.key, torch.as_tensor(idxs).reshape(-1).to(self.device))
        out = torch.empty((k0.shape[0], dim), dtype=torch.float32, device=self.device)
        return _fill_normals(out, k0, k1)

    def sample_index_batch(self, gen: torch.Generator, dim: int, n: int) -> torch.Tensor:
        """``n`` ids, uniform over ``[0, count - dim]`` (noise.py:143-145),
        int32 on the CPU."""
        return _sample_offsets(self.count, gen, dim, n)


def _sample_offsets(size: int, gen: torch.Generator, dim: int, n: int) -> torch.Tensor:
    if size < dim:
        raise ValueError(f"noise source ({size}) smaller than dim ({dim})")
    return torch.randint(0, size - dim + 1, (n,), generator=gen, dtype=torch.int64).to(torch.int32)


def noise_rows(source, idxs: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B, dim]`` rows of a ``NoiseTable``, a ``VirtualNoise`` or a bare
    ``[count]`` table tensor, on the source's device."""
    if isinstance(source, torch.Tensor):
        source = NoiseTable(source)
    return source.get_batch(idxs, dim)


def noise_row(source, i: int, dim: int) -> torch.Tensor:
    """One ``[dim]`` row of any source ``noise_rows`` takes."""
    return noise_rows(source, torch.tensor([int(i)]), dim)[0]
