"""Running observation statistics for obs normalization.

The counterpart of the JAX package's ops/obstat.py (es_distributed/
es.py:26-48 ``RunningStat``): sum and sumsq start at eps, count at eps;
mean = sum/count, std = sqrt(max(sumsq/count − mean², 1e-2));
``set_from_init`` rebuilds the sums from a mean, std and count. float32
tensors on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class RunningStat(NamedTuple):
    sum: torch.Tensor  # [shape] f32
    sumsq: torch.Tensor  # [shape] f32
    count: torch.Tensor  # scalar f32


def init(shape: Tuple[int, ...], eps: float, device=None) -> RunningStat:
    return RunningStat(
        torch.zeros(shape, dtype=torch.float32, device=device),
        torch.full(shape, eps, dtype=torch.float32, device=device),
        torch.tensor(eps, dtype=torch.float32, device=device),
    )


def increment(stat: RunningStat, s: torch.Tensor, ssq: torch.Tensor, c) -> RunningStat:
    return RunningStat(stat.sum + s, stat.sumsq + ssq, stat.count + c)


def mean(stat: RunningStat) -> torch.Tensor:
    return stat.sum / stat.count


def std(stat: RunningStat) -> torch.Tensor:
    m = mean(stat)
    return torch.sqrt(torch.clamp(stat.sumsq / stat.count - m * m, min=1e-2))


def set_from_init(init_mean, init_std, init_count: float, device=None) -> RunningStat:
    """es.py:45-48: the sums of ``init_count`` observations of the given
    mean and std."""
    m = torch.as_tensor(init_mean, dtype=torch.float32, device=device)
    s = torch.as_tensor(init_std, dtype=torch.float32, device=device)
    return RunningStat(m * init_count, (m * m + s * s) * init_count,
                       torch.tensor(init_count, dtype=torch.float32, device=device))
