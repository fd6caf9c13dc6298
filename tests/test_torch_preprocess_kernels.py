"""The preprocessing kernels (csrc/preprocess.cu) behind envs/preprocess.py's
``preprocess_obs`` and ``stack_step``.

On the CPU: what the kernels are given (the resize taps, the luminance
tables, the ctypes declarations), their arithmetic emulated against the
plain chains, and that CPU tensors keep the plain chains. On the card
(marked ``cuda``, skipped without one): each kernel against its plain chain
at the benchmark's shapes and at odd ones. This file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_kernels.py
"""

import ctypes
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_neuroevolution_torch.envs import preprocess as pre
from deep_neuroevolution_torch.ops import _cuda_build

ROOT = Path(__file__).resolve().parents[1]
ULP2 = 2.4e-7  # two float32 ulps at 1.0: the kernels' sums against cuBLAS's
CPU_TOL = 1e-6  # against the CPU's chain, whose products sum in another order too


def _frames(B, H=210, W=160, seed=0, device="cpu", offset=0):
    """uint8 frame pairs ``[B, 2, H, W]``; ``offset`` bytes in front move
    them off 16-byte alignment."""
    g = np.random.default_rng(seed)
    f = torch.from_numpy(g.integers(0, 256, size=(B, 2, H, W), dtype=np.uint8))
    buf = torch.empty(offset + f.numel(), dtype=torch.uint8, device=device)
    out = buf[offset:].view(B, 2, H, W)
    out.copy_(f)
    return out


PLAIN = {"gray": pre.preprocess_gray_frames, "indexed": pre.preprocess_frames}


# ------------------------------------------------------------------ the CPU

def test_taps_rebuild_the_interpolation_matrices():
    """Every (in, out) of 1-256 → 1-84: the taps put back each matrix bit
    for bit, lo ≤ hi, and a row with one nonzero has w_hi = 0."""
    for out_size in range(1, 85):
        for in_size in range(1, 257):
            m = pre._interp_matrix(in_size, out_size)
            taps = pre.resize_taps(in_size, out_size)
            w = taps.view(np.float32)
            rebuilt = np.zeros_like(m)
            rows = np.arange(out_size)
            rebuilt[rows, taps[:, 0]] += w[:, 2]
            rebuilt[rows, taps[:, 1]] += w[:, 3]
            assert np.array_equal(rebuilt.view(np.int32), m.view(np.int32)), (in_size, out_size)
            assert (taps[:, 0] <= taps[:, 1]).all() and (w[taps[:, 0] == taps[:, 1], 3] == 0).all()


def test_gray_table_commutes_with_the_pair_max():
    """For all 65,536 byte pairs max(T[a], T[b]) == T[max(a, b)], and T is
    the plain chain's own scale of each byte, bit for bit."""
    T = pre.LUMA_TABLES["gray"]
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    assert np.array_equal(np.maximum(T[a], T[b]), T[np.maximum(a, b)])
    chain = torch.arange(256, dtype=torch.uint8).to(torch.float32) * (1.0 / 255.0)
    assert np.array_equal(chain.numpy().view(np.int32), T.view(np.int32))
    assert pre._kernel_operands("gray", 4, 4, 2, 2, torch.device("cpu"))[2]
    assert not pre._kernel_operands("indexed", 4, 4, 2, 2, torch.device("cpu"))[2]  # the palette goes up and down


def _emulate(frames: np.ndarray, mode: str, out_h: int, out_w: int) -> np.ndarray:
    """The frames kernel's arithmetic in numpy: each pixel max(T[a], T[b]),
    then fma(w_hi, v[hi], w_lo · v[lo]) over rows and then columns (the
    fma as a float64 sum of exact products, rounded to float32)."""
    T = pre.LUMA_TABLES[mode]
    img = np.maximum(T[frames[:, 0]], T[frames[:, 1]])  # [B, H, W] f32

    def pass_(x, taps, axis):
        w = taps.view(np.float32)
        lo, hi = np.take(x, taps[:, 0], axis=axis), np.take(x, taps[:, 1], axis=axis)
        shape = [1] * x.ndim
        shape[axis] = -1
        wlo, whi = w[:, 2].reshape(shape), w[:, 3].reshape(shape)
        prod = (wlo * lo).astype(np.float32)
        return (whi.astype(np.float64) * hi + prod).astype(np.float32)

    rows = pass_(img, pre.resize_taps(frames.shape[2], out_h), 1)
    return pass_(rows, pre.resize_taps(frames.shape[3], out_w), 2)[..., None]


@pytest.mark.parametrize("mode", ["gray", "indexed"])
@pytest.mark.parametrize("shape", [(3, 210, 160, 84, 84), (2, 211, 161, 42, 42), (2, 211, 161, 1, 1)])
def test_kernel_arithmetic_matches_the_plain_chain(mode, shape):
    B, H, W, oh, ow = shape
    f = _frames(B, H, W, seed=B + H)
    got = _emulate(f.numpy(), mode, oh, ow)
    want = PLAIN[mode](f, oh, ow).numpy()
    assert got.shape == want.shape and np.abs(got - want).max() <= CPU_TOL


def test_cpu_tensors_take_the_plain_chains():
    """CPU tensors run the chains and leave the kernels' counters alone."""
    before = pre.frames_kernel.launches, pre.stack_kernel.launches
    f = _frames(3)
    for mode, plain in PLAIN.items():
        obs = pre.preprocess_obs(f, mode)
        assert torch.equal(obs, plain(f, 84, 84))
    stack = pre.stack_reset(obs)
    assert torch.equal(pre.stack_step(stack, obs), torch.cat([stack[..., 1:], obs], dim=-1))
    assert (pre.frames_kernel.launches, pre.stack_kernel.launches) == before


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shrunk_cell(name: str):
    """The benchmark's cell ``name`` cut to the harness tests' size."""
    from nevobench import registry

    cells = _load_module(ROOT / "nevobench" / "tests" / "cells.py", "nevobench_test_cells")
    return cells.shrink(registry.cell(name))


def test_benchmark_step_on_the_cpu_launches_no_kernel():
    from nevobench.loops.population_step import Run

    run = Run(_shrunk_cell("ga_atari.step_gray"), 2**31 + 7, torch.device("cpu"))
    before = pre.frames_kernel.launches, pre.stack_kernel.launches
    run.step()
    assert (pre.frames_kernel.launches, pre.stack_kernel.launches) == before


class _FakeLib:
    """Stands in for the ctypes library: any attribute is a function
    object whose ``argtypes`` and ``restype`` can be set."""

    def __init__(self, path):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, type("Fn", (), {})())


def _declared(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_cuda_build, "build", lambda verbose=False: Path("libfake.so"))
    monkeypatch.setattr(_cuda_build.ctypes, "CDLL", _FakeLib)
    return _cuda_build.load.__wrapped__()


RETURNS = {"int": ctypes.c_int, "void": None, "const char*": ctypes.c_char_p}


def _arg_ctype(decl: str):
    """The ctypes type of a C parameter (its type and name)."""
    if "*" in decl:
        return ctypes.c_void_p
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong}[decl.rsplit(" ", 1)[0]]


def _c_entries():
    """name → (restype, argtypes) of every ``extern "C"`` function of
    csrc/*.cu, as ctypes has to be told them."""
    pattern = re.compile(r'extern "C" ([\w ]+\*?) ?(nevo_\w+)\(([^)]*)\)')
    out = {}
    for src in _cuda_build.sources():
        for ret, name, params in pattern.findall(src.read_text()):
            args = [_arg_ctype(" ".join(p.split())) for p in params.split(",") if p.strip()]
            out[name] = (RETURNS[ret.strip()], args)
    return out


C_ENTRIES = _c_entries()


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_every_entry_point_is_declared_as_its_c_signature(monkeypatch, name):
    """A pointer or the stream as ``c_void_p``, an int as ``c_int``, a long
    long as ``c_longlong``: anything else cuts a pointer or a size."""
    lib = _declared(monkeypatch)
    restype, args = C_ENTRIES[name]
    assert lib.fns[name].argtypes == args and lib.fns[name].restype is restype


# ----------------------------------------------------------------- the card

@pytest.fixture
def card():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels are CUDA C++ with no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check_frames(card, mode, B, H, W, oh, ow, offset=0):
    f = _frames(B, H, W, seed=B * 7 + H, device=card, offset=offset)
    before = pre.frames_kernel.launches
    got = pre.preprocess_obs(f, mode, oh, ow)
    assert pre.frames_kernel.launches == before + 1
    torch.cuda.synchronize()
    assert got.shape == (B, oh, ow, 1) and got.dtype == torch.float32
    chain = PLAIN[mode](f, oh, ow)
    assert float((got - chain).abs().max()) <= ULP2
    cpu = PLAIN[mode](f.cpu(), oh, ow)
    assert float((got.cpu() - cpu).abs().max()) <= CPU_TOL
    assert torch.equal(pre.frames_kernel(f, mode, oh, ow), got)  # a repeat, bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gray", "indexed"])
@pytest.mark.parametrize("B", [1, 3, 500, 2500])
def test_frames_kernel_at_the_cells_shape(card, mode, B):
    _check_frames(card, mode, B, 210, 160, 84, 84)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["gray", "indexed"])
@pytest.mark.parametrize("shape", [(3, 211, 161, 84, 84), (3, 211, 161, 42, 42), (3, 211, 161, 1, 1),
                                   (5, 210, 160, 42, 42)])
def test_frames_kernel_at_odd_shapes(card, mode, shape):
    _check_frames(card, mode, *shape)


@pytest.mark.cuda
def test_frames_kernel_off_alignment(card):
    """Frames one byte off 16-byte alignment take the byte loads."""
    _check_frames(card, "gray", 4, 210, 160, 84, 84, offset=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 5])
@pytest.mark.parametrize("B", [1, 2500])
def test_stack_kernel_equals_cat(card, n, B):
    g = torch.Generator(device=card).manual_seed(B + n)
    stack = torch.rand((B, 84, 84, n), generator=g, device=card)
    frame = torch.rand((B, 84, 84, 1), generator=g, device=card)
    before = pre.stack_kernel.launches
    got = pre.stack_step(stack, frame)
    assert pre.stack_kernel.launches == before + 1
    assert got.data_ptr() != stack.data_ptr() and torch.equal(got, pre.stack_step_plain(stack, frame))


@pytest.mark.cuda
def test_stack_kernel_off_alignment(card):
    """A stack one float off 16-byte alignment takes the general path."""
    buf = torch.rand(1 + 3 * 5 * 5 * 4, device=card)
    stack, frame = buf[1:].view(3, 5, 5, 4), torch.rand((3, 5, 5, 1), device=card)
    assert torch.equal(pre.stack_kernel(stack, frame), pre.stack_step_plain(stack, frame))


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(card):
    stack, frame = torch.rand((2, 84, 84, 4), device=card), torch.rand((2, 84, 84, 1), device=card)
    bad = [(stack.transpose(1, 2), frame), (stack.double(), frame), (stack, frame.half()),
           (stack, frame.transpose(1, 2)), (stack, frame[:1])]
    for s, f in bad:
        with pytest.raises(ValueError):
            pre.stack_step(s, f)
    frames = _frames(2, device=card)
    for f in (frames.transpose(2, 3), frames.to(torch.int32), frames[:, :1]):
        with pytest.raises(ValueError):
            pre.preprocess_obs(f, "gray")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["es_atari.step_gray", "ga_atari.step_gray"])
def test_benchmark_step_launches_each_kernel_once_a_group(card, workload):
    from nevobench.loops.population_step import Run

    run = Run(_shrunk_cell(workload), 2**31 + 11, card)
    assert run.G == 2
    before = pre.frames_kernel.launches, pre.stack_kernel.launches
    run.step()
    assert (pre.frames_kernel.launches - before[0], pre.stack_kernel.launches - before[1]) == (2, 2)
    run.close()
