"""Device resolution for every entry point of the port.

An entry point takes ``device=None`` (meaning ``cuda``) or an explicit
device. With no CUDA device it raises ``NoCudaDevice``: the port never
drops to the CPU behind the caller's back. Tests pass ``device="cpu"``,
which runs each kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


class NoCudaDevice(RuntimeError):
    """Raised when a CUDA device is asked for and none is available."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``. Raises ``NoCudaDevice`` for a CUDA device on a
    machine without one, and ``ValueError`` for anything but cpu/cuda."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "no CUDA device: deep_neuroevolution_torch runs on a CUDA GPU by "
                "default; pass device='cpu' (CLI: --device cpu) to run the plain "
                "PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
