"""Parameters and obs stats from the JAX package into the port.

The JAX package keeps θ as one flat float32 vector in ParamSpec order; the
port keeps the same layout (ops/flat.py). ``from_jax`` takes the JAX
package's parameters as numpy arrays — a flat θ ``[D]`` or ``[B, D]``, or
the name → array dict its ``unflatten`` gives — and returns the port's
tensors of the same shape: a flat tensor for a flat θ, a dict of tensors
for a dict. Given the JAX package's obs stats (its ops/obstat.py
``RunningStat``, or any object with ``sum``, ``sumsq`` and ``count``), it
returns the port's ``RunningStat``. The values are copied unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .device import resolve_device
from .ops.obstat import RunningStat


def from_jax(params, device=None) -> Union[torch.Tensor, Dict[str, torch.Tensor], RunningStat]:
    dev = resolve_device(device)
    to = lambda v: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)  # noqa: E731
    if isinstance(params, Mapping):
        return {k: to(v) for k, v in params.items()}
    if all(hasattr(params, f) for f in RunningStat._fields):
        return RunningStat(*(to(getattr(params, f)) for f in RunningStat._fields))
    return to(params)
