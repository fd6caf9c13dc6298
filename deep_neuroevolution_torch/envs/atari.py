"""Atari env family on the C++ batched host engine.

The counterpart of the JAX package's envs/atari.py ``AtariEnv`` for
``game="toy"`` (the engine's ToyCatch backend, which has ALE's frame,
reset and RAM contract). ``obs_mode`` says what the engine ships a slot a
step (envs/preprocess.py ``preprocess_obs`` does the rest on the device,
algos/rollout_host.py the stack):

* 'gray' (the default): frame pairs through the engine's gray LUT,
  ``[n, 2, 210, 160]`` uint8 (67,200 bytes);
* 'indexed': the raw indexed-color frame pairs, the same shape; the device
  applies the float32 palette, the reference's own path;
* 'preproc': the engine also takes the 2-frame max and the resize and ships
  ``[n, 84, 84]`` uint8 (7,056 bytes); it rounds after the resize, so its
  observations differ from 'gray''s by up to 0.5/255 a pixel.

``episodic_life`` turns on EpisodicLife episodes (atari_wrappers.py:50-84):
the CPU stack's ``wrap_deepmind`` default for training envs, which
utils/config.py enables for ``<Game>NoFrameskip-v4`` ids, as the JAX
package does. The behavior characterization is the 128 RAM bytes.

Not ported yet: ALE games.
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
    bc_dim = 128  # RAM bytes (tf_atari.cpp:114-119; policies.py:410-418)

    def __init__(
        self,
        game: str = "toy",
        batch_size: int = 64,
        num_threads: int = 0,
        pipeline_groups: int = 2,
        episodic_life: bool = False,
        obs_mode: str = "gray",
    ):
        from ..native.bridge import HostBatchEnv

        if game != "toy":
            raise NotImplementedError(
                f"game {game!r}: the port's engine has no ALE; run the experiment on the "
                "ToyCatch engine with game 'toy' (CLI override {\"game\": \"toy\"})"
            )
        if obs_mode not in ("gray", "indexed", "preproc"):
            raise ValueError(f"obs_mode must be 'gray', 'indexed' or 'preproc', not {obs_mode!r}")
        self.game = game
        self.num_threads = num_threads
        self._env = HostBatchEnv("toy", batch_size, num_threads, episodic_life=episodic_life)
        self.episodic_life = episodic_life
        self.obs_mode = obs_mode
        if obs_mode != "indexed":
            self._env.set_gray_lut(GRAY_PALETTE_UINT8)
        self.num_actions = self._env.num_actions
        self.batch_size = batch_size
        self.obs_shape = (self.warp_size, self.warp_size, 4)
        self.default_timestep_cutoff = DEFAULT_TIMESTEP_CUTOFF
        # slot groups the rollout interleaves, so the device computes one
        # group's actions while the engine steps another
        self.pipeline_groups = pipeline_groups

    def spawn(self) -> "AtariEnv":
        """A fresh engine pool of the same kind (a pod's emulated rank owns
        one, as a real rank does)."""
        return AtariEnv(self.game, self.batch_size, self.num_threads, self.pipeline_groups, self.episodic_life,
                        self.obs_mode)

    def reset(self, noops: np.ndarray, indices=None, max_frames: int = DEFAULT_TIMESTEP_CUTOFF, seeds=None):
        self._env.reset(noops, indices=indices, max_frames=max_frames, seeds=seeds)

    def step(self, actions: np.ndarray, indices=None):
        return self._env.step(actions, indices=indices)

    def observe(self, indices=None) -> np.ndarray:
        """The ``obs_mode``'s frames: pairs ``[n, 2, 210, 160]`` uint8 (gray
        or indexed), or ``[n, 84, 84]`` uint8 (preproc)."""
        if self.obs_mode == "preproc":
            return self._env.observe_preproc(self.warp_size, self.warp_size, indices=indices)
        if self.obs_mode == "gray":
            return self._env.observe_gray(indices=indices)
        return self._env.observe(indices=indices)

    def final_state(self, indices=None) -> np.ndarray:
        """RAM bytes as floats ``[n, 128]`` (tf_atari.cpp:114-119)."""
        return self._env.final_state(indices=indices)

    def close(self) -> None:
        self._env.close()
