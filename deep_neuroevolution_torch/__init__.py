"""deep_neuroevolution_torch — the PyTorch/CUDA port of deep_neuroevolution_tpu.

The layout mirrors the JAX package (ops/, models/, envs/, native/, algos/,
utils/, main.py) so each module's counterpart is easy to find. θ keeps the
same flat layout (ops/flat.py ParamSpec order and offsets), so a θ vector
moves between the two packages unchanged.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a CUDA device it raises ``NoCudaDevice`` instead
of falling back (device.py). Kernels written by hand for Hopper live in
csrc/ and are built with nvcc at first use (ops/_cuda_build.py); on a CPU
tensor each kernel's wrapper runs its plain PyTorch version.

Importing this package imports torch and numpy only: no kernel is built and
no engine is loaded until a function needs it.
"""

__version__ = "0.1.0"

from .device import NoCudaDevice, resolve_device  # noqa: F401
