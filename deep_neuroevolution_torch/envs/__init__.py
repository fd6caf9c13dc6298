"""Environments: the Atari host engine (ToyCatch backend)."""

from .atari import AtariEnv  # noqa: F401
