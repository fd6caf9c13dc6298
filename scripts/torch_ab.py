"""What the port's A/B scripts share (scripts/torch_k1_ab.py,
scripts/torch_k3_ab.py): build another copy of a kernel's CUDA source into
its own library, and time two callables in turns on one card.

The timing primitives (``cuda_ms``, ``graph_ms``, ``warm``) are
chip_smoke.py's, so that an A/B reads the same clock as the smoke run.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def build_other(source: Path, name: str) -> ctypes.CDLL:
    """nvcc ``source`` (with the port's flags; its quoted includes resolve
    next to it, so a copy of another commit's csrc/ brings its own headers)
    into a shared library and load it."""
    from deep_neuroevolution_torch.ops import _cuda_build

    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda_build.BUILD_DIR) as tmp:
        so = Path(tmp) / f"lib{name}.so"
        subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-shared", str(source), "-o", str(so)],
                       check=True)
        return ctypes.CDLL(str(so))


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def in_turns(other, this, iters: int = 50) -> dict:
    """Both warmed, then timed in the order other, this, this, other:
    back-to-back calls (``ms``) and calls in a CUDA graph (``graph_ms``)."""
    from chip_smoke import cuda_ms, graph_ms, warm

    warm(other)
    warm(this)
    order = [other, this, this, other]
    return dict(order="other this this other", ms=[cuda_ms(f, iters) for f in order],
                graph_ms=[graph_ms(f) for f in order])


def host_us(fn, n: int = 2000) -> float:
    """Host microseconds per call, no synchronisation inside the loop."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t
