"""ctypes bridge to the batched host env engine (env_engine.cpp).

``HostBatchEnv`` is the batched, index-addressable env interface of the
reference's TF env ops (gym_tensorflow/tf_env.py:27-80): reset(indices,
noops, max_frames, seeds), step(actions, indices) → (reward, done),
final_state(indices), with EpisodicLife episodes on request, and three
observations: ``observe`` (indexed-color frame pairs), ``observe_gray``
(frame pairs through the engine's gray LUT) and ``observe_preproc`` (the
LUT, the 2-frame max and the align-corners resize in the engine, one uint8
frame a slot). NumPy staging buffers are reused across calls.

The backend is "toy" (ToyCatch) or "ale" (a ROM path as ``arg``), the
latter where the library was built with ALE (native/build.py: ``build(
with_ale=...)``, or ``build_ale_stub()``'s library through ``lib_path``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from .build import ensure_built


@functools.lru_cache(maxsize=None)
def _load(path: Optional[str] = None) -> ctypes.CDLL:
    """The engine library at ``path`` (default: ``ensure_built``'s), its
    functions typed; loaded once a path."""
    lib = ctypes.CDLL(str(path or ensure_built()))
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
    lib.nevo_observe.restype = None
    lib.nevo_observe.argtypes = [ctypes.c_void_p, iptr, ctypes.c_int, u8ptr]
    lib.nevo_observe_preproc.restype = None
    lib.nevo_observe_preproc.argtypes = [ctypes.c_void_p, iptr, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8ptr]
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
    """Batched host simulator pool of ``batch_size`` slots of ``backend``
    ("toy", or "ale" with the ROM path ``arg``), from the engine library
    at ``lib_path`` (default: ``ensure_built``'s)."""

    def __init__(self, backend: str = "toy", arg: str = "", batch_size: int = 64, num_threads: int = 0,
                 episodic_life: bool = False, lib_path: Optional[str] = None):
        lib = _load(str(lib_path) if lib_path else None)
        self._lib = lib
        self._h = lib.nevo_create(backend.encode(), arg.encode(), batch_size, num_threads)
        if not self._h:
            raise RuntimeError(f"engine backend {backend!r} unavailable in {lib_path or 'the default engine'} "
                               "(ALE is compiled in only with NEVO_ALE_PREFIX, native/build.py)")
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

    def observe(self, indices=None) -> np.ndarray:
        """Indexed-color frames ``[n, frames, H, W]`` uint8 (tf_atari.cpp:
        57-62), a copy: the staging buffer is reused by the next call."""
        idx = self._idx(indices)
        n = idx.size
        self._lib.nevo_observe(self._h, idx, n, self._obs[:n].reshape(-1))
        return self._obs[:n].copy()

    def set_gray_lut(self, lut256: np.ndarray) -> None:
        """Install the indexed-color → luminance LUT used by observe_gray
        and observe_preproc."""
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

    def observe_preproc(self, out_h: int = 84, out_w: int = 84, indices=None) -> np.ndarray:
        """Frames preprocessed in the engine, ``[n, out_h, out_w]`` uint8:
        the gray LUT (set_gray_lut first), the 2-frame max and the
        align-corners bilinear resize, rounded to uint8 at the end. A copy."""
        idx = self._idx(indices)
        n = idx.size
        if getattr(self, "_pre", None) is None or self._pre.shape[1:] != (out_h, out_w):
            self._pre = np.zeros((self.batch_size, out_h, out_w), np.uint8)
        self._lib.nevo_observe_preproc(self._h, idx, n, out_h, out_w, self._pre[:n].reshape(-1))
        return self._pre[:n].copy()

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
