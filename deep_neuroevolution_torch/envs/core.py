"""Batched device environments: the protocol and the registry.

The counterpart of the JAX package's envs/core.py. There an env is a set of
pure functions over the state of one instance, batched by ``jax.vmap`` at
the rollout layer. Here an env works on a whole batch at once: its state is
a NamedTuple of ``[B, ...]`` tensors on one device, and every method is
tensor ops over the batch, so the rollout steps all B slots in lockstep
with the population forward and without the host.

* ``reset(B, gen, device)`` → state. Randomness comes from the explicit
  ``torch.Generator`` ``gen`` (envs that reset deterministically ignore it);
* ``observe(state)`` → ``[B, *obs_shape]`` float32;
* ``step(state, actions)`` → ``(state, reward [B] f32, done [B] bool)``;
* ``behavior(state)`` → ``[B, bc_dim]`` float32, the final-state behavior
  characterization.

``make`` resolves 'maze', 'gym.<EnvId>' (and the bare registered ids) to
the device envs, and any other name to the Atari host engine
(envs/atari.py), which serves 'toy'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Discrete action space of n choices (gym.spaces.Discrete analog)."""

    n: int


@dataclasses.dataclass(frozen=True)
class Continuous:
    """Box action space [low, high]^dim (gym.spaces.Box analog)."""

    dim: int
    low: Tuple[float, ...] = ()
    high: Tuple[float, ...] = ()


class Env:
    """Batched device-env protocol; see the module docstring."""

    obs_shape: Tuple[int, ...]
    action_space: Any
    default_timestep_cutoff: int = 100_000  # tf_env.py:21-25
    bc_dim: int = 0  # behavior-characterization length (0 = none)

    def reset(self, B: int, gen: torch.Generator, device: torch.device):
        raise NotImplementedError

    def observe(self, state) -> torch.Tensor:
        raise NotImplementedError

    def step(self, state, actions: torch.Tensor):
        raise NotImplementedError

    def behavior(self, state) -> torch.Tensor:
        raise NotImplementedError

    @property
    def discrete_action(self) -> bool:
        return isinstance(self.action_space, Discrete)


def uniform(gen: torch.Generator, shape, low: float, high: float, device: torch.device) -> torch.Tensor:
    """float32 draws in [low, high) from ``gen`` (on its own device), moved
    to ``device``."""
    r = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (r * (high - low) + low).to(device)


_REGISTRY: Dict[str, Callable[..., Env]] = {}


def register(name: str, ctor: Callable[..., Env]) -> None:
    _REGISTRY[name] = ctor


def make(game: str, **kwargs):
    """'maze' → Hard Maze, 'gym.<EnvId>' → the classic-control ports, any
    other name → the Atari host engine (gym_tensorflow/__init__.py:7-14)."""
    if game in _REGISTRY:
        return _REGISTRY[game](**kwargs)
    if game.startswith("gym.") and game[4:] in _REGISTRY:
        return _REGISTRY[game[4:]](**kwargs)
    if game.startswith("gym."):
        raise ValueError(f"unknown gym env {game!r}; registered: {sorted(_REGISTRY)}")
    from .atari import AtariEnv

    return AtariEnv(game, **kwargs)
