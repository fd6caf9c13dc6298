"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` (which may include the shared ``csrc/*.cuh`` headers) is
compiled by its own nvcc process, all started together, and one more nvcc
call links the objects into one shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c csrc/<name>.cu -o <tmp>/<name>.o     # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o _build/libnevo_kernels-<hash>.so <tmp>/*.o

Each exported function returns a ``cudaError_t``. The library goes to the
package's ``_build/`` directory (git ignores it), is named by a hash of the
sources and flags, and is reused while they are unchanged. The build runs
at first use, never at import. No PyTorch headers are compiled, so the
build takes seconds.

Pointers go to the C functions as ``c_void_p`` from ``Tensor.data_ptr()``,
the stream as ``c_void_p``: the raw handle of PyTorch's current stream.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..device import NoCudaDevice

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")


def lib_path() -> Path:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnevo_kernels-{h.hexdigest()[:16]}.so"


def _run(cmd: list) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless the library for these sources exists.
    The library is linked under a temporary name and renamed, so processes
    that build at the same time never load a half-written file."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources()]
        with concurrent.futures.ThreadPoolExecutor(len(objs)) as pool:
            logs = list(pool.map(
                _run, ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj] for src, obj in zip(sources(), objs))
            ))
        lib = str(Path(tmp) / "lib.so")
        logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]))
        if verbose and any(logs):
            import sys

            print("".join(logs), file=sys.stderr)
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process.
    Raises ``NoCudaDevice`` on a machine without a CUDA device."""
    if not torch.cuda.is_available():
        raise NoCudaDevice("no CUDA device: the CUDA kernels need one")
    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nevo_population_linear.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.nevo_population_linear.restype = i32
    lib.nevo_population_linear_bulk.argtypes = [vp] * 5 + [i32] * 9 + [vp]
    lib.nevo_population_linear_bulk.restype = i32
    lib.nevo_population_linear_bulk_occupancy.argtypes = [i32, i32]
    lib.nevo_population_linear_bulk_occupancy.restype = i32
    lib.nevo_noise_gradient.argtypes = [vp, vp, vp, i32, i64, vp, vp]
    lib.nevo_noise_gradient.restype = i32
    lib.nevo_noise_gradient_geometry.argtypes = [i64, i32, vp]
    lib.nevo_noise_gradient_geometry.restype = None
    lib.nevo_l2_read_probe.argtypes = [vp, i64, i32, i32, vp, vp]
    lib.nevo_l2_read_probe.restype = i32
    lib.nevo_large_dqn_fused.argtypes = [vp] * 12 + [i32, vp]
    lib.nevo_large_dqn_fused.restype = i32
    lib.nevo_dqn_conv_chain.argtypes = [vp] * 8 + [i32, i32, i32, i32, i32, vp]
    lib.nevo_dqn_conv_chain.restype = i32
    for name in ("nevo_vbn_dqn_fused1", "nevo_vbn_dqn_fused"):
        getattr(lib, name).argtypes = [vp] * 13 + [i32, vp]
        getattr(lib, name).restype = i32
        getattr(lib, name + "_split").argtypes = [vp] * 15 + [i32, i32, vp]
        getattr(lib, name + "_split").restype = i32
    lib.nevo_cuda_error_string.argtypes = [i32]
    lib.nevo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel launch returned a non-zero ``cudaError_t``."""
    if err:
        msg = lib.nevo_cuda_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the launch plans of K1
    and K4/K6 divide their work over."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def current_stream(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``,
    from the getter PyTorch's generated kernels use: 0.1 µs a call, against
    5.3 µs for building a ``torch.cuda.Stream`` and reading its
    ``cuda_stream`` (measured on the host of an H100)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
