"""Pendulum as batched tensor ops.

The counterpart of the JAX package's envs/pendulum.py, gym's Pendulum-v1:
θ'' = 3g/(2l)·sin θ + 3/(m l²)·u, dt 0.05, g 10, m = l = 1, torque clipped
to ±2, speed to ±8; reward −(angle_norm(θ)² + 0.1·θ'² + 0.001·u²);
200-step episodes; reset θ ~ U(−π, π), θ' ~ U(−1, 1); observation
[cos θ, sin θ, θ']. It serves the MujocoPolicy stack (Box actions, obs
normalization, action bins, action noise) on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Continuous, Env, register, uniform

MAX_SPEED = 8.0
MAX_TORQUE = 2.0
DT = 0.05
G = 10.0
M = 1.0
L = 1.0
EPISODE_STEPS = 200


class PendulumState(NamedTuple):
    theta: torch.Tensor  # [B] f32
    theta_dot: torch.Tensor
    t: torch.Tensor  # [B] int32


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    """Into [−π, π) by the remainder with the divisor's sign."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class PendulumEnv(Env):
    obs_shape = (3,)
    action_space = Continuous(1, (-MAX_TORQUE,), (MAX_TORQUE,))
    default_timestep_cutoff = EPISODE_STEPS
    bc_dim = 2  # the final (cos θ, sin θ)

    def reset(self, B: int, gen: torch.Generator, device=None) -> PendulumState:
        theta = uniform(gen, (B,), -math.pi, math.pi, device)
        theta_dot = uniform(gen, (B,), -1.0, 1.0, device)
        return PendulumState(theta, theta_dot, torch.zeros(B, dtype=torch.int32, device=theta.device))

    def observe(self, state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], dim=1)

    def step(self, state: PendulumState, actions: torch.Tensor):
        u = torch.clamp(actions.reshape(-1), -MAX_TORQUE, MAX_TORQUE)
        th = _angle_normalize(state.theta)
        cost = th * th + 0.1 * (state.theta_dot * state.theta_dot) + 0.001 * (u * u)
        new_dot = state.theta_dot + (3 * G / (2 * L) * torch.sin(state.theta) + 3.0 / (M * L**2) * u) * DT
        new_dot = torch.clamp(new_dot, -MAX_SPEED, MAX_SPEED)
        theta = state.theta + new_dot * DT
        t = state.t + 1
        return PendulumState(theta, new_dot, t), -cost, t >= EPISODE_STEPS

    def behavior(self, state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta)], dim=1)


register("Pendulum-v1", lambda **kw: PendulumEnv(**kw))
