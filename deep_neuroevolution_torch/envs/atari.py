"""Atari env family on the C++ batched host engine, gray observations.

The counterpart of the JAX package's envs/atari.py ``AtariEnv`` for
``game="toy"`` (the engine's ToyCatch backend, which has ALE's frame,
reset and RAM contract) and ``obs_mode="gray"``: the engine decodes
indexed color to luminance with a LUT and ships gray uint8 frame pairs;
the device does the 2-frame max, the resize and the stack
(envs/preprocess.py, algos/rollout_host.py).

Not ported yet: ALE games, EpisodicLife, and the 'indexed' and 'preproc'
obs modes.
"""

from __future__ import annotations

import numpy as np

from .preprocess import GRAY_PALETTE_UINT8

FRAMESKIP = 4
DEFAULT_TIMESTEP_CUTOFF = 100_000 * FRAMESKIP  # tf_atari.py:40-41


class AtariEnv:
    """Batched host-engine env, driven by ``algos.rollout_host``."""

    is_host_env = True
    warp_size = 84  # frames are resized to warp_size × warp_size (tf_atari.py:93)

    def __init__(
        self,
        game: str = "toy",
        batch_size: int = 64,
        num_threads: int = 0,
        pipeline_groups: int = 2,
    ):
        from ..native.bridge import HostBatchEnv

        if game != "toy":
            raise NotImplementedError(
                f"game {game!r}: the port's engine has no ALE; run the experiment on the "
                "ToyCatch engine with game 'toy' (CLI override {\"game\": \"toy\"})"
            )
        self.game = game
        self._env = HostBatchEnv("toy", batch_size, num_threads)
        self._env.set_gray_lut(GRAY_PALETTE_UINT8)
        self.num_actions = self._env.num_actions
        self.batch_size = batch_size
        self.obs_shape = (self.warp_size, self.warp_size, 4)
        self.default_timestep_cutoff = DEFAULT_TIMESTEP_CUTOFF
        # slot groups the rollout interleaves, so the device computes one
        # group's actions while the engine steps another
        self.pipeline_groups = pipeline_groups

    def reset(self, noops: np.ndarray, indices=None, max_frames: int = DEFAULT_TIMESTEP_CUTOFF, seeds=None):
        self._env.reset(noops, indices=indices, max_frames=max_frames, seeds=seeds)

    def step(self, actions: np.ndarray, indices=None):
        return self._env.step(actions, indices=indices)

    def observe(self, indices=None) -> np.ndarray:
        """Gray frame pairs ``[n, 2, 210, 160]`` uint8."""
        return self._env.observe_gray(indices=indices)

    def final_state(self, indices=None) -> np.ndarray:
        """RAM bytes as floats ``[n, 128]`` (tf_atari.cpp:114-119)."""
        return self._env.final_state(indices=indices)

    def close(self) -> None:
        self._env.close()
