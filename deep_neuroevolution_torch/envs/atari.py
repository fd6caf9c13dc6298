"""Atari env family on the C++ batched host engine.

The counterpart of the JAX package's envs/atari.py ``AtariEnv``: ``game=
"toy"`` runs the engine's ToyCatch backend, which has ALE's frame, reset
and RAM contract; a game of the Atari suite runs on the engine's ALE
backend, which is compiled in only when the engine is built against an
ALE install (``NEVO_ALE_PREFIX``, native/build.py), with the ROM at
``rom_path`` (default ``<game>.bin``). ``is_available()`` says whether the
engine has ALE; without it a game is refused, naming the build. ``obs_mode`` says what the engine ships a slot a
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
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .preprocess import GRAY_PALETTE_UINT8

# minimal-action-set sizes per game (tf_atari.py:152-213 game_actions)
GAME_ACTIONS = {
    "air_raid": 6, "alien": 18, "amidar": 10, "assault": 7, "asterix": 9,
    "asteroids": 14, "atlantis": 4, "bank_heist": 18, "battle_zone": 18,
    "beam_rider": 9, "berzerk": 18, "bowling": 6, "boxing": 18, "breakout": 4,
    "carnival": 6, "centipede": 18, "chopper_command": 18, "crazy_climber": 9,
    "demon_attack": 6, "double_dunk": 18, "elevator_action": 18, "enduro": 9,
    "fishing_derby": 18, "freeway": 3, "frostbite": 18, "gopher": 8,
    "gravitar": 18, "hero": 18, "ice_hockey": 18, "jamesbond": 18,
    "journey_escape": 16, "kangaroo": 18, "krull": 18, "kung_fu_master": 14,
    "montezuma_revenge": 18, "ms_pacman": 9, "name_this_game": 6, "phoenix": 8,
    "pitfall": 18, "pong": 6, "pooyan": 6, "private_eye": 18, "qbert": 6,
    "riverraid": 18, "road_runner": 18, "robotank": 18, "seaquest": 18,
    "skiing": 3, "solaris": 18, "space_invaders": 6, "star_gunner": 18,
    "tennis": 18, "time_pilot": 10, "tutankham": 8, "up_n_down": 6,
    "venture": 18, "video_pinball": 9, "wizard_of_wor": 10,
    "yars_revenge": 18, "zaxxon": 18,
}
GAMES = tuple(GAME_ACTIONS)

FRAMESKIP = 4
DEFAULT_TIMESTEP_CUTOFF = 100_000 * FRAMESKIP  # tf_atari.py:40-41


def is_available() -> bool:
    """Whether the default engine was built with ALE (the JAX package's
    envs/atari.py:50-58)."""
    try:
        from ..native.bridge import HostBatchEnv

        HostBatchEnv("ale", "", 1).close()
        return True
    except Exception:
        return False


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
        rom_path: Optional[str] = None,
    ):
        from ..native.bridge import HostBatchEnv

        if game != "toy" and game not in GAME_ACTIONS:
            raise ValueError(f"{game!r} is not in the Atari suite")
        if game != "toy" and not is_available():
            raise NotImplementedError(
                f"game {game!r}: the port's engine has no ALE (build it against an ALE install with "
                "NEVO_ALE_PREFIX, native/build.py), or run the experiment on the ToyCatch engine with game "
                "'toy' (CLI override {\"game\": \"toy\"})"
            )
        if obs_mode not in ("gray", "indexed", "preproc"):
            raise ValueError(f"obs_mode must be 'gray', 'indexed' or 'preproc', not {obs_mode!r}")
        self.game = game
        self.num_threads = num_threads
        self.rom_path = rom_path
        if game == "toy":
            self._env = HostBatchEnv("toy", "", batch_size, num_threads, episodic_life=episodic_life)
        else:
            self._env = HostBatchEnv("ale", rom_path or f"{game}.bin", batch_size, num_threads,
                                     episodic_life=episodic_life)
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
                        self.obs_mode, self.rom_path)

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
