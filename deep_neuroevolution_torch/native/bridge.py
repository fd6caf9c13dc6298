"""ctypes bridge to the batched host env engine (env_engine.cpp).

``HostBatchEnv`` is the batched, index-addressable env interface of the
reference's TF env ops (gym_tensorflow/tf_env.py:27-80): reset(indices,
noops, max_frames, seeds), step(actions, indices) → (reward, done),
observe(indices), final_state(indices), with EpisodicLife episodes on
request. NumPy staging buffers are reused across calls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from .build import ensure_built


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(ensure_built()))
    iptr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    fptr = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8ptr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.nevo_create.restype = ctypes.c_void_p
    lib.nevo_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.nevo_destroy.restype = None
    lib.nevo_destroy.argtypes = [ctypes.c_void_p]
    lib.nevo_set_episodic_life.restype = None
    lib.nevo_set_episodic_life.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.nevo_obs_shape.restype = None
    lib.nevo_obs_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.nevo_action_count.restype = ctypes.c_int
    lib.nevo_action_count.argtypes = [ctypes.c_void_p]
    lib.nevo_reset.restype = None
    lib.nevo_reset.argtypes = [ctypes.c_void_p, iptr, iptr, iptr, ctypes.c_int]
    lib.nevo_reset_seeded.restype = None
    lib.nevo_reset_seeded.argtypes = [ctypes.c_void_p, iptr, iptr, iptr, iptr, ctypes.c_int]
    lib.nevo_step.restype = None
    lib.nevo_step.argtypes = [ctypes.c_void_p, iptr, iptr, ctypes.c_int, fptr, u8ptr]
    lib.nevo_set_gray_lut.restype = None
    lib.nevo_set_gray_lut.argtypes = [ctypes.c_void_p, u8ptr]
    lib.nevo_observe_gray.restype = None
    lib.nevo_observe_gray.argtypes = [ctypes.c_void_p, iptr, ctypes.c_int, u8ptr]
    lib.nevo_final_state_size.restype = ctypes.c_int
    lib.nevo_final_state_size.argtypes = [ctypes.c_void_p]
    lib.nevo_final_state.restype = None
    lib.nevo_final_state.argtypes = [ctypes.c_void_p, iptr, ctypes.c_int, fptr]
    return lib


class HostBatchEnv:
    """Batched host simulator pool. Only the "toy" backend (ToyCatch) is
    built into the port's engine."""

    def __init__(self, backend: str = "toy", batch_size: int = 64, num_threads: int = 0, episodic_life: bool = False):
        lib = _load()
        self._lib = lib
        self._h = lib.nevo_create(backend.encode(), b"", batch_size, num_threads)
        if not self._h:
            raise RuntimeError(f"engine backend {backend!r} unavailable (the port's engine is built without ALE)")
        if episodic_life:
            # EpisodicLife training episodes (atari_wrappers.py:50-84): done on
            # a life lost; the game restarts only on game over, and a reset
            # after a life lost goes on with one no-op step
            lib.nevo_set_episodic_life(self._h, 1)
        self.batch_size = batch_size
        dims = (ctypes.c_int * 3)()
        lib.nevo_obs_shape(self._h, dims)
        self.frames_per_obs, self.height, self.width = dims[0], dims[1], dims[2]
        self.num_actions = lib.nevo_action_count(self._h)
        self.final_state_size = lib.nevo_final_state_size(self._h)
        self._all = np.arange(batch_size, dtype=np.int32)
        self._rew = np.zeros(batch_size, np.float32)
        self._done = np.zeros(batch_size, np.uint8)
        self._obs = np.zeros((batch_size, self.frames_per_obs, self.height, self.width), np.uint8)
        self._fs = np.zeros((batch_size, self.final_state_size), np.float32)

    def _idx(self, indices) -> np.ndarray:
        if indices is None:
            return self._all
        idx = np.ascontiguousarray(indices, np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= self.batch_size):
            raise IndexError(f"slot indices outside [0, {self.batch_size})")
        return idx

    def reset(self, noops: np.ndarray, indices=None, max_frames: int = 100_000,
              seeds: Optional[np.ndarray] = None) -> None:
        """Reset slots with per-slot noop counts and, optionally, per-slot
        episode seeds (tf_env.cpp:115-176 EnvironmentReset)."""
        idx = self._idx(indices)
        noops = np.ascontiguousarray(noops, np.int32)
        if noops.shape != idx.shape:
            raise ValueError(f"{noops.size} noop counts for {idx.size} slots")
        mf = np.full(idx.size, max_frames, np.int32)
        if seeds is not None:
            sd = np.ascontiguousarray(seeds, np.int32)
            self._lib.nevo_reset_seeded(self._h, idx, noops, mf, sd, idx.size)
        else:
            self._lib.nevo_reset(self._h, idx, noops, mf, idx.size)

    def step(self, actions: np.ndarray, indices=None):
        idx = self._idx(indices)
        acts = np.ascontiguousarray(actions, np.int32)
        if acts.shape != idx.shape:
            raise ValueError(f"{acts.shape[0]} actions for {idx.size} slots")
        n = idx.size
        self._lib.nevo_step(self._h, idx, acts, n, self._rew[:n], self._done[:n])
        return self._rew[:n].copy(), self._done[:n].astype(bool)

    def set_gray_lut(self, lut256: np.ndarray) -> None:
        """Install the indexed-color → luminance LUT used by observe_gray."""
        lut = np.ascontiguousarray(lut256, np.uint8)
        if lut.shape != (256,):
            raise ValueError("the gray LUT has 256 entries")
        self._lib.nevo_set_gray_lut(self._h, lut)

    def observe_gray(self, indices=None) -> np.ndarray:
        """LUT-mapped gray frames ``[n, frames, H, W]`` uint8 (a copy: the
        staging buffer is reused by the next call)."""
        idx = self._idx(indices)
        n = idx.size
        self._lib.nevo_observe_gray(self._h, idx, n, self._obs[:n].reshape(-1))
        return self._obs[:n].copy()

    def final_state(self, indices=None) -> np.ndarray:
        """Each slot's final state ``[n, final_state_size]`` f32: the RAM
        bytes as floats (tf_atari.cpp:114-119), the GA's behavior
        characterization. A copy."""
        idx = self._idx(indices)
        n = idx.size
        self._lib.nevo_final_state(self._h, idx, n, self._fs[:n].reshape(-1))
        return self._fs[:n].copy()

    def close(self) -> None:
        """Stop the engine's threads and free it; idempotent."""
        if getattr(self, "_h", None):
            self._lib.nevo_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()
