"""MuJoCo continuous-control envs (Humanoid et al.) on a batched host engine.

The counterpart of the JAX package's envs/mujoco.py. The CPU stack rolls one
gym env a worker through MujocoPolicy.rollout (es_distributed/policies.py:
258-302), with the mass centre's x-y as the behavior characterization
(policies.py:252-257 ``_get_pos``: Σ mᵢ·xiposᵢ / Σ m) and the trajectory
padded with the final position (policies.py:295-297).

MuJoCo's physics runs on the host, so ``MujocoHostEnv`` is a host engine
like the Atari one: B gymnasium envs stepped by a thread pool (``mj_step``
releases the GIL). ``host_obs = "vector"``: the rollout
(algos/rollout_host.py ``rollout_host_vec``) uploads the raw ``[B,
obs_dim]`` float32 observations each step and runs the population forward
on the device; there is no image preprocessing.

Headline workload: configurations/humanoid.json (the reference's
Humanoid-v1). Gymnasium ships Humanoid-v5 (348-float observations, the
contact forces left out by default); ``resolve_env_id`` maps a
reference-era id onto the newest registered version of its task.

``deceptive_humanoid_xml`` writes the deceptive world of the NS-ES humanoid
experiment (the reference's extra/humanoid_maze.xml, README.md:82-84): a
three-sided wall trap ahead of the start, put into gymnasium's stock
humanoid model.

Gymnasium and mujoco are imported inside the functions that need them, so
the module imports where they are missing (``is_available`` says whether
they are there).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .core import Continuous

MUJOCO_FAMILIES = (
    "Humanoid",
    "HumanoidStandup",
    "HalfCheetah",
    "Hopper",
    "Walker2d",
    "Ant",
    "Swimmer",
    "InvertedPendulum",
    "InvertedDoublePendulum",
    "Reacher",
    "Pusher",
    "HumanoidTrap",
)

# where deceptive_humanoid_xml writes its world (git ignores the directory)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"


def resolve_env_id(env_id: str) -> str:
    """A reference-era env id (Humanoid-v1, configurations/humanoid.json)
    → the id gymnasium registers: the id itself when registered, else the
    highest registered version of the same task."""
    import gymnasium as gym

    registry = gym.registry
    if env_id in registry:
        return env_id
    base = env_id.split("-")[0]
    versions = sorted(
        int(k.split("-v")[1])
        for k in registry
        if k.split("-")[0] == base and "-v" in k and k.split("-v")[1].isdigit()
    )
    if not versions:
        raise ValueError(f"no gymnasium registration for {env_id!r}")
    return f"{base}-v{versions[-1]}"


def is_available() -> bool:
    """Whether gymnasium and mujoco import here."""
    try:
        import gymnasium  # noqa: F401
        import mujoco  # noqa: F401

        return True
    except Exception:
        return False


def _mass_center_xy(env) -> tuple:
    """The mass centre's (x, y): policies.py:252-257 ``_get_pos``."""
    model = env.unwrapped.model
    data = env.unwrapped.data
    mass = model.body_mass
    center = (mass[:, None] * data.xipos).sum(axis=0) / mass.sum()
    return float(center[0]), float(center[1])


class MujocoHostEnv:
    """B gymnasium MuJoCo envs as one batched host engine with vector
    observations, driven by ``algos.rollout_host.rollout_host_vec``.

    ``reset(indices, seeds)``, ``step(actions, indices)`` → (rewards,
    dones) of those slots, ``observe()`` → ``[B, obs_dim]`` float32,
    ``final_state()`` → each slot's behavior characterization
    (policies.py:293-299):

    * ``bc_mode='final_pos'``: the final mass centre (x, y), ``bc_dim`` 2;
    * ``bc_mode='traj'``: (x_0 … x_{T−1}, y_0 … y_{T−1}) of the first
      ``traj_len`` steps, padded with the last position, ``bc_dim`` 2·T.

    Rollouts are clamped to the env's registered episode cap
    (``max_episode_steps``; policies.py:264-265)."""

    is_host_env = True
    host_obs = "vector"

    def __init__(
        self,
        env_id: str = "Humanoid-v5",
        batch_size: int = 64,
        num_threads: int = 0,
        bc_mode: str = "final_pos",
        traj_len: int = 1000,
        xml_file: Optional[str] = None,
        seed: int = 0,
    ):
        import gymnasium as gym

        if bc_mode not in ("final_pos", "traj"):
            raise ValueError(f"bc_mode must be 'final_pos' or 'traj', not {bc_mode!r}")
        self.env_id = env_id
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.xml_file = xml_file
        self.seed = seed
        kwargs = {} if xml_file is None else {"xml_file": xml_file}
        self._envs = [gym.make(env_id, **kwargs) for _ in range(batch_size)]
        e0 = self._envs[0]
        self.obs_shape = tuple(e0.observation_space.shape)
        space = e0.action_space
        self.action_space = Continuous(
            dim=int(space.shape[0]),
            low=tuple(np.asarray(space.low, np.float64).tolist()),
            high=tuple(np.asarray(space.high, np.float64).tolist()),
        )
        spec_max = getattr(e0.spec, "max_episode_steps", None) or 1000
        self.max_episode_steps = int(spec_max)
        self.default_timestep_cutoff = int(spec_max)
        self.bc_mode = bc_mode
        self.traj_len = int(traj_len)
        self.bc_dim = 2 if bc_mode == "final_pos" else 2 * self.traj_len

        self._pool = ThreadPoolExecutor(max_workers=num_threads or min(batch_size, os.cpu_count() or 1))
        self._obs = np.zeros((batch_size,) + self.obs_shape, np.float32)
        self._done = np.ones(batch_size, bool)
        self._xy = np.zeros((batch_size, 2), np.float64)  # the current mass centre
        self._traj = np.zeros((batch_size, self.traj_len, 2), np.float64) if bc_mode == "traj" else None
        self._t = np.zeros(batch_size, np.int64)  # each slot's step index
        self._rng = np.random.default_rng(seed)

    def spawn(self) -> "MujocoHostEnv":
        """A fresh pool of the same kind (a pod's emulated rank owns one, as
        a real rank does)."""
        return MujocoHostEnv(self.env_id, self.batch_size, self.num_threads, self.bc_mode, self.traj_len,
                             self.xml_file, self.seed)

    def _reset_one(self, i: int, seed: int) -> None:
        ob, _ = self._envs[i].reset(seed=seed)
        self._obs[i] = ob
        self._done[i] = False
        self._t[i] = 0
        self._xy[i] = _mass_center_xy(self._envs[i])
        if self._traj is not None:
            self._traj[i] = self._xy[i]

    def reset(self, indices: Optional[np.ndarray] = None, seeds: Optional[Sequence[int]] = None) -> None:
        """Reset the slots ``indices`` (all by default), each from its
        episode seed (drawn from the env's own generator when not given)."""
        idx = np.arange(self.batch_size) if indices is None else np.asarray(indices)
        if seeds is None:
            seeds = self._rng.integers(0, 2**31 - 1, size=idx.size)
        list(self._pool.map(self._reset_one, idx.tolist(), [int(s) for s in seeds]))

    def _step_one(self, i: int, action: np.ndarray) -> tuple:
        env = self._envs[i]
        ob, rew, term, trunc, _ = env.step(action)
        self._obs[i] = ob
        xy = _mass_center_xy(env)
        self._xy[i] = xy
        if self._traj is not None and self._t[i] < self.traj_len:
            self._traj[i, self._t[i]] = xy
        self._t[i] += 1
        done = bool(term or trunc)
        self._done[i] = done
        return float(rew), done

    def step(self, actions: np.ndarray, indices: Optional[np.ndarray] = None):
        """Step the slots ``indices`` (all by default) → (rewards [n] f32,
        dones [n] bool) of those slots."""
        idx = np.arange(self.batch_size) if indices is None else np.asarray(indices)
        actions = np.asarray(actions, np.float64)
        if actions.shape[0] != idx.size:
            raise ValueError(f"{actions.shape[0]} actions for {idx.size} slots")
        out = list(self._pool.map(self._step_one, idx.tolist(), actions))
        return np.array([o[0] for o in out], np.float32), np.array([o[1] for o in out], bool)

    def observe(self) -> np.ndarray:
        """Every slot's observation ``[B, obs_dim]`` float32 (the engine's
        buffer, rewritten by the next step)."""
        return self._obs

    def final_state(self) -> np.ndarray:
        """Every slot's behavior characterization ``[B, bc_dim]`` float32;
        for 'traj', the steps past a slot's episode hold its last mass
        centre (policies.py:295-297), laid out (x_0 … x_T, y_0 … y_T)
        (policies.py:298)."""
        if self.bc_mode == "final_pos":
            return self._xy.astype(np.float32)
        out = self._traj.copy()
        for i in range(self.batch_size):
            t = min(int(self._t[i]), self.traj_len)
            if t < self.traj_len:
                out[i, t:] = out[i, t - 1] if t > 0 else self._xy[i]
        return np.concatenate([out[..., 0], out[..., 1]], axis=1).astype(np.float32)

    def close(self) -> None:
        for e in self._envs:
            e.close()
        self._pool.shutdown(wait=False)


_TRAP_SNIPPET = """
    <geom name="trap_front" type="box" pos="{d} 0 1" size="0.2 {w} 1"
          rgba="0.6 0.2 0.2 1" contype="1" conaffinity="1"/>
    <geom name="trap_left" type="box" pos="{hd} {w} 1" size="{hd} 0.2 1"
          rgba="0.6 0.2 0.2 1" contype="1" conaffinity="1"/>
    <geom name="trap_right" type="box" pos="{hd} -{w} 1" size="{hd} 0.2 1"
          rgba="0.6 0.2 0.2 1" contype="1" conaffinity="1"/>
"""


def deceptive_humanoid_xml(distance: float = 4.0, half_width: float = 2.0) -> str:
    """The humanoid world with a U-shaped wall trap that opens toward the
    start (README.md:82-84): walking straight ahead, the reward's gradient,
    ends at the wall, and the agent must go round it. Gymnasium's stock
    humanoid model with three wall geoms added. Returns the path of the
    XML, a file of the package's ``_build/`` named by a hash of its text:
    every call with the same arguments returns the same file, written once
    (the JAX package's version leaves a new temporary file on every call)."""
    import gymnasium.envs.mujoco as gm

    base = os.path.join(os.path.dirname(gm.__file__), "assets", "humanoid.xml")
    with open(base) as f:
        xml = f.read()
    if "</worldbody>" not in xml:
        raise ValueError(f"{base} has no </worldbody>")
    snippet = _TRAP_SNIPPET.format(d=distance, hd=distance / 2, w=half_width)
    xml = xml.replace("</worldbody>", snippet + "\n  </worldbody>")
    path = BUILD_DIR / f"humanoid_trap-{hashlib.sha256(xml.encode()).hexdigest()[:16]}.xml"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".xml", dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(xml)
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)  # processes that write it at once never read half a file
    return str(path)
