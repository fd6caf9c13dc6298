"""Environments: the batched device envs (Hard Maze, CartPole, Pendulum)
and the Atari host engine (ToyCatch backend), resolved by ``make``."""

from .atari import AtariEnv  # noqa: F401
from .cartpole import CartPoleEnv  # noqa: F401  (each device env's module registers it)
from .core import Continuous, Discrete, Env, make, register  # noqa: F401
from .maze import MazeEnv  # noqa: F401
from .pendulum import PendulumEnv  # noqa: F401
