"""Parameters from the JAX package into the port.

The JAX package keeps θ as one flat float32 vector in ParamSpec order; the
port keeps the same layout (ops/flat.py). ``from_jax`` takes the JAX
package's parameters as numpy arrays — a flat θ ``[D]`` or ``[B, D]``, or
the name → array dict its ``unflatten`` gives — and returns the port's
tensors of the same shape: a flat tensor for a flat θ, a dict of tensors
for a dict. The values are copied unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .device import resolve_device


def from_jax(
    params: Union[np.ndarray, Mapping[str, np.ndarray]], device=None
) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    dev = resolve_device(device)
    if isinstance(params, Mapping):
        return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev) for k, v in params.items()}
    return torch.from_numpy(np.array(params, dtype=np.float32)).to(dev)
