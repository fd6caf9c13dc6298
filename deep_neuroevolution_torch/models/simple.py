"""Small policies for the device envs: the gym classifiers and the maze MLP.

The counterpart of the JAX package's models/simple.py (the reference's
gpu_implementation/neuroevolution/models/simple.py:22-35): flatten the
observation, dense layers with per-member weights (``dense``, a batched
product), and an argmax action, or for ``ContinuousMLP`` a tanh output
scaled into [-0.5, 0.5] for the Hard Maze (tf_maze.cpp:80 adds the 0.5).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..ops.flat import ParamSpec
from .core import NONLINS, Model, dense


def _flat_obs(obs: torch.Tensor) -> torch.Tensor:
    return obs.reshape(obs.shape[0], -1).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class LinearClassifier(Model):
    obs_dim: int = 0
    num_actions: int = 0
    nonlin_type: str = "relu"

    def build_specs(self) -> Sequence[ParamSpec]:
        return [
            ParamSpec("out/w", (self.obs_dim, self.num_actions), "normc", 1.0),
            ParamSpec("out/b", (self.num_actions,), "zeros"),
        ]

    def batch_scores_parts(self, parts, obs, ctx=None) -> torch.Tensor:
        return dense(parts, "out", _flat_obs(obs))

    def batch_act_parts(self, parts, obs, ctx=None) -> torch.Tensor:
        return torch.argmax(self.batch_scores_parts(parts, obs, ctx), dim=1)


@dataclasses.dataclass(frozen=True)
class SimpleClassifier(Model):
    """fc16 → fc16 → out (normc 0.1), argmax (simple.py:29-35)."""

    obs_dim: int = 0
    num_actions: int = 0
    nonlin_type: str = "relu"

    def build_specs(self) -> Sequence[ParamSpec]:
        return [
            ParamSpec("fc1/w", (self.obs_dim, 16), "normc", 1.0),
            ParamSpec("fc1/b", (16,), "zeros"),
            ParamSpec("fc2/w", (16, 16), "normc", 1.0),
            ParamSpec("fc2/b", (16,), "zeros"),
            ParamSpec("out/w", (16, self.num_actions), "normc", 0.1),
            ParamSpec("out/b", (self.num_actions,), "zeros"),
        ]

    def batch_scores_parts(self, parts, obs, ctx=None) -> torch.Tensor:
        nonlin = NONLINS[self.nonlin_type]
        x = nonlin(dense(parts, "fc1", _flat_obs(obs)))
        x = nonlin(dense(parts, "fc2", x))
        return dense(parts, "out", x)

    def batch_act_parts(self, parts, obs, ctx=None) -> torch.Tensor:
        return torch.argmax(self.batch_scores_parts(parts, obs, ctx), dim=1)


@dataclasses.dataclass(frozen=True)
class ContinuousMLP(Model):
    """fc → fc → tanh(out)·0.5: raw continuous actions in [-0.5, 0.5]."""

    obs_dim: int = 0
    ac_dim: int = 0
    hidden: int = 16
    nonlin_type: str = "tanh"

    def build_specs(self) -> Sequence[ParamSpec]:
        return [
            ParamSpec("fc1/w", (self.obs_dim, self.hidden), "normc", 1.0),
            ParamSpec("fc1/b", (self.hidden,), "zeros"),
            ParamSpec("fc2/w", (self.hidden, self.hidden), "normc", 1.0),
            ParamSpec("fc2/b", (self.hidden,), "zeros"),
            ParamSpec("out/w", (self.hidden, self.ac_dim), "normc", 0.1),
            ParamSpec("out/b", (self.ac_dim,), "zeros"),
        ]

    def batch_act_parts(self, parts, obs, ctx=None) -> torch.Tensor:
        nonlin = NONLINS[self.nonlin_type]
        x = nonlin(dense(parts, "fc1", _flat_obs(obs)))
        x = nonlin(dense(parts, "fc2", x))
        return torch.tanh(dense(parts, "out", x)) * 0.5
