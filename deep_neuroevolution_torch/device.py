"""Device resolution for every entry point of the port.

An entry point takes ``device=None`` (meaning ``cuda``) or an explicit
device. With no CUDA device it raises ``NoCudaDevice``: the port never
drops to the CPU behind the caller's back. Tests pass ``device="cpu"``,
which runs each kernel's plain PyTorch version.

A rank of a ``torchrun`` world (``LOCAL_RANK`` and ``WORLD_SIZE`` > 1 in
its environment) that asks for ``cuda`` without an index gets its own
card, ``cuda:LOCAL_RANK``; two ranks that share a card name it
(``cuda:0``) and talk over gloo (parallel/distributed.py).
"""

from __future__ import annotations

import os

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
            dev = torch.device("cuda", _local_card())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def _local_card() -> int:
    """The card of this process: ``LOCAL_RANK`` in a torchrun world of more
    than one rank, else the current device."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "LOCAL_RANK" not in os.environ:
        return torch.cuda.current_device()
    local = int(os.environ["LOCAL_RANK"])
    if local >= torch.cuda.device_count():
        raise NoCudaDevice(
            f"local rank {local} has no card of its own ({torch.cuda.device_count()} visible): start one rank "
            "per card, or name the shared card (device='cuda:0') and use the gloo backend"
        )
    return local
