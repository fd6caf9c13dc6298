"""Flat-vector optimizers: Adam and SGD with momentum.

The counterpart of the JAX package's ops/optim.py (es_distributed/
optimizers.py:1-51). ``update(state, θ, g)`` returns the new state, the new
θ and the update ratio ‖step‖/‖θ‖. It allocates new tensors and leaves its
inputs as they were, like the JAX version. Adam's scalar factor is
computed in float32 tensors, as the JAX version computes it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SGDState(NamedTuple):
    t: int
    v: torch.Tensor  # [D]


class AdamState(NamedTuple):
    t: int
    m: torch.Tensor  # [D]
    v: torch.Tensor  # [D]


def _ratio(step: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(step) / torch.linalg.vector_norm(theta)


class SGD:
    """SGD with momentum. ``momentum_style``: "openai" v = m·v + (1−m)·g
    (es_distributed/optimizers.py:29-32) or "tf" v = m·v + g (the GPU
    stack's optimizers.py:44-49)."""

    def __init__(self, stepsize: float, momentum: float = 0.9, momentum_style: str = "openai"):
        if momentum_style not in ("openai", "tf"):
            raise ValueError(f"unknown momentum_style {momentum_style!r}")
        self.stepsize = stepsize
        self.momentum = momentum
        self.momentum_style = momentum_style

    def init(self, dim: int, device=None) -> SGDState:
        return SGDState(0, torch.zeros(dim, dtype=torch.float32, device=device))

    def update(self, state: SGDState, theta: torch.Tensor, globalg: torch.Tensor):
        if self.momentum_style == "openai":
            v = self.momentum * state.v + (1.0 - self.momentum) * globalg
        else:
            v = self.momentum * state.v + globalg
        step = -self.stepsize * v
        return SGDState(state.t + 1, v), theta + step, _ratio(step, theta)


class Adam:
    """Adam on the flat parameter vector (optimizers.py:35-50)."""

    def __init__(self, stepsize: float, beta1: float = 0.9, beta2: float = 0.999, epsilon: float = 1e-08):
        self.stepsize = stepsize
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init(self, dim: int, device=None) -> AdamState:
        z = lambda: torch.zeros(dim, dtype=torch.float32, device=device)  # noqa: E731
        return AdamState(0, z(), z())

    def update(self, state: AdamState, theta: torch.Tensor, globalg: torch.Tensor):
        t = state.t + 1
        tf_ = torch.tensor(float(t), dtype=torch.float32, device=theta.device)
        a = self.stepsize * torch.sqrt(1.0 - self.beta2**tf_) / (1.0 - self.beta1**tf_)
        m = self.beta1 * state.m + (1.0 - self.beta1) * globalg
        v = self.beta2 * state.v + (1.0 - self.beta2) * (globalg * globalg)
        step = -a * m / (torch.sqrt(v) + self.epsilon)
        return AdamState(t, m, v), theta + step, _ratio(step, theta)


OPTIMIZERS = {"sgd": SGD, "adam": Adam}


def make_optimizer(type_name: str, **kwargs):
    """Constructor from the experiment JSON's ``optimizer{type, args}``."""
    return OPTIMIZERS[type_name.lower()](**kwargs)
