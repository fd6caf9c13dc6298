"""Environments: the batched device envs (Hard Maze, CartPole, Pendulum),
the Atari host engine (ToyCatch, and ALE games where the engine was built
with ALE) resolved by ``make``, and the MuJoCo host engine
(``MujocoHostEnv``, which needs gymnasium and mujoco; utils/config.py
resolves its ids)."""

from . import mujoco  # noqa: F401
from .atari import AtariEnv  # noqa: F401
from .cartpole import CartPoleEnv  # noqa: F401  (each device env's module registers it)
from .core import Continuous, Discrete, Env, make, register  # noqa: F401
from .maze import MazeEnv  # noqa: F401
from .mujoco import MujocoHostEnv  # noqa: F401
from .pendulum import PendulumEnv  # noqa: F401
