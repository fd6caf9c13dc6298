"""How ``correct`` is decided for a cell whose timed path answers with
actions: the greedy action of each member at each step.

For every action read back, the reference's scores of the same member on
the same frame stack say how far the chosen action's score lies below the
best one: its gap, 0 where the program chose the reference's argmax. Where
two scores lie within rounding of each other either choice is sound, so
the check is on the gap and not on equality. The run is correct when the
widest gap of all its actions is within the configuration's limit (set in
PERF.md from the program's readings and the lower-precision control's).
An action outside the action set has an infinite gap.
"""

from __future__ import annotations

import numpy as np
import torch


def gaps(scores: torch.Tensor, index: np.ndarray, actions: np.ndarray) -> np.ndarray:
    """``scores`` ``[P, B, A]`` of the distinct stacks, ``index`` ``[K]``
    each step's stack, ``actions`` ``[K, B]`` → gaps ``[K, B]`` (float64)."""
    s = scores.double().numpy()  # [P, B, A]
    A = s.shape[2]
    valid = (actions >= 0) & (actions < A)
    chosen = s[index[:, None], np.arange(s.shape[1])[None, :], np.clip(actions, 0, A - 1)]
    out = s.max(axis=2)[index] - chosen
    out[~valid] = np.inf
    return out


def action_gaps(scores: torch.Tensor, index: np.ndarray, actions: np.ndarray, limit: float, first: int) -> dict:
    """The check of a run, in the form ``run.py`` prints: its widest gap
    against ``limit`` over every action read back, the count of actions of
    steps ``first`` on (the measured window's) and of those over the limit.
    An action outside the set reads 1e300 (JSON has no infinity)."""
    g = gaps(scores, index, actions)
    widest = float(g.max())
    return {
        "correct": bool(widest <= limit),
        "attempted": int(g[first:].size),
        "failed": int((g[first:] > limit).sum()),
        "checks": {"action_gap_max": {"value": min(widest, 1e300), "limit": float(limit)}},
    }
