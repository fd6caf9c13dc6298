"""CartPole as batched tensor ops.

The counterpart of the JAX package's envs/cartpole.py, gym's CartPole-v1
(Euler integration, tau 0.02, force ±10, half pole length 0.5, masses 1.0
and 0.1; done past |x| > 2.4 or |θ| > 12°, latched; reward 1 on every step,
the terminal one included; reset state uniform in [-0.05, 0.05)^4). The
reference reaches it as ``gym.CartPole-v1`` (gym_tensorflow/tf_env.py:31-123,
es_gym_config.json). ``CartPole-v0`` differs only in its cutoff, 200.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .core import Discrete, Env, register, uniform

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSPOLE + MASSCART
LENGTH = 0.5  # half the pole's length
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4


class CartPoleState(NamedTuple):
    x: torch.Tensor  # [B] f32
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor
    done: torch.Tensor  # [B] bool, latched


class CartPoleEnv(Env):
    obs_shape = (4,)
    action_space = Discrete(2)
    bc_dim = 1  # the final cart position

    def __init__(self, default_timestep_cutoff: int = 500):
        self.default_timestep_cutoff = default_timestep_cutoff

    def reset(self, B: int, gen: torch.Generator, device=None) -> CartPoleState:
        v = uniform(gen, (B, 4), -0.05, 0.05, device)
        return CartPoleState(v[:, 0], v[:, 1], v[:, 2], v[:, 3], torch.zeros(B, dtype=torch.bool, device=v.device))

    def observe(self, state: CartPoleState) -> torch.Tensor:
        return torch.stack([state.x, state.x_dot, state.theta, state.theta_dot], dim=1)

    def step(self, state: CartPoleState, actions: torch.Tensor):
        force = torch.where(actions.to(torch.int32) == 1, FORCE_MAG, -FORCE_MAG).to(torch.float32)
        costheta = torch.cos(state.theta)
        sintheta = torch.sin(state.theta)
        temp = (force + POLEMASS_LENGTH * (state.theta_dot * state.theta_dot) * sintheta) / TOTAL_MASS
        thetaacc = (GRAVITY * sintheta - costheta * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * (costheta * costheta) / TOTAL_MASS)
        )
        xacc = temp - POLEMASS_LENGTH * thetaacc * costheta / TOTAL_MASS
        x = state.x + TAU * state.x_dot
        x_dot = state.x_dot + TAU * xacc
        theta = state.theta + TAU * state.theta_dot
        theta_dot = state.theta_dot + TAU * thetaacc
        done = (torch.abs(x) > X_LIMIT) | (torch.abs(theta) > THETA_LIMIT) | state.done
        reward = torch.ones_like(x)  # gym pays the terminal step too
        return CartPoleState(x, x_dot, theta, theta_dot, done), reward, done

    def behavior(self, state: CartPoleState) -> torch.Tensor:
        return state.x[:, None]


register("CartPole-v1", lambda **kw: CartPoleEnv(**kw))
register("CartPole-v0", lambda **kw: CartPoleEnv(**{"default_timestep_cutoff": 200, **kw}))
