"""Point replay for the interactive inspector.

The port's copy of the JAX package's inspector/replay.py (after
visual_inspector/figure_base/rollout_base.py:30-60,
figure_custom/rollout_custom.py and figure_custom/rollout_trajectory.py):
rebuild the clicked offspring's θ' = parent θ + sign·σ·ε[noise_idx] and
roll it out through the port's own replay path (utils/viz.py
``replay_snapshot``: the device env's scan, or the host engine), on
``device`` (default cuda; ``NoCudaDevice`` without a card).

θ' is formed on the device in float32 as the JAX package forms it in
numpy: the product ``float32(sign·σ)·ε``, rounded, then the sum with θ,
rounded; two roundings, no fused multiply-add. It is the JAX package's θ'
bit for bit.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .load_data import load_parent


def _parent_snapshot(path: str, gen: int) -> str:
    f = os.path.join(path, "snapshots", f"snapshot_gen_{gen:04d}", f"snapshot_parent_{gen:04d}.h5")
    if not os.path.exists(f):
        raise FileNotFoundError(
            f"no parent policy snapshot for gen {gen} under {path} (train with vine_snapshot_dir set to dump them)"
        )
    return f


def perturbed_theta(theta, noise_table, noise_idx: int, scale: float):
    """``θ + float32(scale)·ε[noise_idx]`` on θ's device, a product and a
    sum, each rounded to float32. ``noise_table``: any source of
    ``ops.noise.noise_row`` (a ``NoiseTable``, a ``VirtualNoise``)."""
    import torch

    from ..ops.noise import noise_row

    eps = noise_row(noise_table, noise_idx, theta.shape[0]).to(theta.device)
    s = torch.tensor(np.float32(scale), device=theta.device)
    prod = eps * s
    return theta + prod


def replay_point(
    path: str,
    point,
    *,
    noise_table=None,
    stochastic: bool = False,
    num_rollouts: int = 1,
    env_id: Optional[str] = None,
    bc_dim: int = 2,
    device=None,
) -> dict:
    """Replay the clicked cloud point.

    ``point`` is an inspector Point: for an offspring, its row carries
    [bc, fitness, length, noise_idx, policy_seed, sign] (utils/vine.py
    layout); the parent row's trailing columns are [seed, noise_stdev].
    Deterministic replay reuses the stored policy_seed as the replay's
    seed (rollout_base.py:46-52). ``noise_table=None`` builds the
    reference's 250M-float table (``NoiseTable.from_seed()``) on
    ``device``."""
    from ..device import resolve_device
    from ..ops.noise import NoiseTable
    from ..utils.checkpoint import load_policy_snapshot
    from ..utils.viz import replay_snapshot

    dev = resolve_device(device)
    snap = _parent_snapshot(path, point.gen)
    theta_override = None
    seed = int(np.random.randint(2**31 - 1))

    if not point.parent:
        row = np.asarray(point.row)
        noise_idx = int(row[bc_dim + 2])
        policy_seed = int(row[bc_dim + 3])
        sign = float(row[bc_dim + 4])
        noise_stdev = float(load_parent(path, point.gen, bc_dim).extras[-1])
        if noise_table is None:
            noise_table = NoiseTable.from_seed(device=dev)
        _, theta, _ = load_policy_snapshot(snap, dev)
        theta_override = perturbed_theta(theta, noise_table, noise_idx, sign * noise_stdev)
        if not stochastic:
            seed = policy_seed

    result = replay_snapshot(snap, env_id=env_id, episodes=num_rollouts, seed=seed, theta_override=theta_override,
                             return_trajectory=True, device=dev)
    result["seed"] = seed
    return result


def plot_replay_trajectory(ax, result, color: str = "k") -> None:
    """Overlay the replayed rollout's BC trajectory on a cloud axis
    (figure_custom/rollout_trajectory.py behavior)."""
    traj = np.asarray(result.get("bc_trajectory"))
    if traj.ndim == 3:  # [T, episodes, bc_dim] from the device scan
        for e in range(traj.shape[1]):
            ax.plot(traj[:, e, 0], traj[:, e, 1], color=color, lw=2, alpha=0.7)
    elif traj.ndim == 2 and traj.shape[1] >= 2:  # [episodes, bc] host engines
        half = traj.shape[1] // 2
        for e in range(traj.shape[0]):
            ax.plot(traj[e, :half], traj[e, half:], color=color, lw=2, alpha=0.7)
