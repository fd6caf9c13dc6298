"""Policy replay: roll a policy file or a seed-chain elite out, headless.

The counterpart of the JAX package's utils/viz.py (after the reference's
scripts/viz.py:10-51 and neuroevolution/display.py:30-89). Rollouts run on
the device env (``rollout_batch_scan``, with the per-step behavior
trajectory) or on the host engine (``rollout_host_batch``), on ``device``
(default cuda; ``NoCudaDevice`` without one, never the CPU behind the
caller's back). ``save_frames`` writes an ``.npz`` with the JAX package's
keys: ``returns``, ``lengths`` and ``bc_trajectory`` (the device env's
``[T, episodes, bc_dim]`` behavior after every step, or the engine's final
RAM ``[episodes, 128]``).

The host arm runs θ on every engine slot, the VBN stats from the file's
reference batch or the file's obs stats (no action noise), in ⌈episodes /
slots⌉ rounds through ``rollout_host``: the Atari engine, or a vector
engine (MuJoCo), whose BC, saved as ``bc_trajectory``, is its final mass
centre or, with its ``bc_mode='traj'``, the x-y trajectory (the JAX
package's viz.py:44-80). Each round's engine seed (the source of the noop
counts and episode seeds, algos/rollout_host.py) is drawn from ``seed``
(``_draw_seeds``, where tests feed the JAX package's in). The device arm
resets ``episodes`` slots from a generator seeded with ``seed``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import models
from ..algos.rollout import collect_ref_batch, rollout_batch_scan
from ..algos.rollout_host import collect_ref_batch_host, rollout_host
from ..device import resolve_device
from ..models.mlp import MLPContext
from ..ops import obstat
from ..ops.noise import NoiseTable
from .checkpoint import load_policy_snapshot, theta_from_seed_chain
from .config import resolve_env


def _draw_seeds(gen: torch.Generator, n: int) -> list:
    """``n`` host seeds (a VBN reference batch's, the engine rounds')."""
    return [int(torch.randint(0, 2**31 - 1, (1,), generator=gen)) for _ in range(n)]


def _expand(stats, n: int):
    """One member's VBN stats for ``n`` slots."""
    return type(stats)(*(tuple(x.expand(n, -1) for x in field) for field in stats))


def replay_policy(
    model,
    theta,
    env,
    episodes: int = 1,
    save_frames: str = "",
    seed: int = 0,
    ob_stat=None,
    ref_batch=None,
    return_trajectory: bool = False,
    device=None,
) -> dict:
    """Roll a flat-θ policy for ``episodes`` episodes; returns its returns,
    lengths and their means (and the trajectory with
    ``return_trajectory``)."""
    dev = resolve_device(device)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    act = model.make_batch_act()
    stats = None
    if model.needs_ref_batch:
        if ref_batch is None:
            raise ValueError(f"{type(model).__name__} needs a reference batch to replay")
        stats = model.batch_ref_stats(theta[None], torch.as_tensor(ref_batch, dtype=torch.float32).to(dev))
    ctx = None
    if stats is None and model.needs_ob_stat and ob_stat is not None:
        st = obstat.RunningStat(*(torch.as_tensor(v, dtype=torch.float32, device=dev) for v in ob_stat))
        ctx = MLPContext(obstat.mean(st), obstat.std(st), 0.0)  # no action noise
    if getattr(env, "is_host_env", False):
        B = env.batch_size
        seeds = _draw_seeds(torch.Generator().manual_seed(seed), -(-episodes // B))
        params = (theta[None].expand(B, -1), ctx if stats is None else _expand(stats, B))
        res = [rollout_host(env, act, params, s, env.default_timestep_cutoff, dev) for s in seeds]
        rets, lens, traj = (np.concatenate([getattr(r, f) for r in res])[:episodes]
                            for f in ("returns", "lengths", "bc"))
    else:
        state = env.reset(episodes, torch.Generator(device=dev).manual_seed(seed), dev)
        if stats is not None:
            ctx = _expand(stats, episodes)
        res, (bc_traj, _) = rollout_batch_scan(env, act, (theta[None].expand(episodes, -1), ctx), state,
                                               env.default_timestep_cutoff)
        rets, lens, traj = (x.cpu().numpy() for x in (res.returns, res.lengths, bc_traj))
    if save_frames:
        np.savez_compressed(save_frames, returns=rets, lengths=lens, bc_trajectory=traj)
    out = {
        "returns": rets.tolist(),
        "lengths": lens.tolist(),
        "return_mean": float(rets.mean()),
        "length_mean": float(lens.mean()),
    }
    if return_trajectory:
        out["bc_trajectory"] = traj
    return out


def replay_snapshot(
    snapshot_path: str,
    env_id: Optional[str] = None,
    episodes: int = 1,
    save_frames: str = "",
    seed: int = 0,
    env_kwargs: Optional[dict] = None,
    theta_override=None,
    return_trajectory: bool = False,
    device=None,
) -> dict:
    """Roll a policy file of either package for ``episodes`` episodes
    (scripts/viz.py:10-51) on ``env_id`` (default: the file's, else the
    maze). ``theta_override`` replaces the file's θ (a VINE offspring)."""
    model, theta, payload = load_policy_snapshot(snapshot_path, device)
    env = resolve_env(env_id or payload["extra"].get("env_id") or "maze", **(env_kwargs or {}))
    try:
        return replay_policy(
            model, theta if theta_override is None else theta_override, env, episodes=episodes,
            save_frames=save_frames, seed=seed, ob_stat=payload.get("ob_stat"), ref_batch=payload.get("ref_batch"),
            return_trajectory=return_trajectory, device=device,
        )
    finally:
        if getattr(env, "is_host_env", False):
            env.close()


def replay_seed_chain(
    seeds: Sequence,
    model_name: str,
    env_id: str,
    model_kwargs: Optional[dict] = None,
    genome_style: str = "gpu",
    noise_stdev: float = 0.002,
    noise_table=None,
    episodes: int = 1,
    save_frames: str = "",
    seed: int = 0,
    env_kwargs: Optional[dict] = None,
    return_trajectory: bool = False,
    device=None,
) -> dict:
    """Rebuild an elite from its seed chain and roll it out (display.py:
    30-89). ``seeds``: GPU-style ``[init, [idx, power], ...]``
    (base.py:143-145) or CPU-style bare indices with ``noise_stdev``
    (es_distributed/ga.py:250-264). ``noise_table``: a ``NoiseTable`` or a
    ``VirtualNoise`` (default: the reference's 250M table). A VBN model's
    reference batch comes from a random policy (``collect_ref_batch_host``
    or ``collect_ref_batch``) on a seed drawn from ``seed + 1``, as the
    replay's rounds draw theirs from ``seed``."""
    dev = resolve_device(device)
    # a class name first, then the registry, as the JAX package resolves it;
    # but "Model", the GPU stack's small DQN, is not the abstract base class
    cls = getattr(models, model_name, None)
    if not (isinstance(cls, type) and issubclass(cls, models.Model)) or cls is models.Model:
        cls = models.get_model(model_name)
    model = cls(**(model_kwargs or {}))
    env = resolve_env(env_id, **(env_kwargs or {}))
    try:
        source = (noise_table or NoiseTable.from_seed(device=dev)).to(dev)
        theta = theta_from_seed_chain(model, source, seeds, genome_style, noise_stdev)
        ref_batch = None
        if model.needs_ref_batch:
            ref_seed = _draw_seeds(torch.Generator().manual_seed(seed + 1), 1)[0]
            if getattr(env, "is_host_env", False):
                ref_batch = collect_ref_batch_host(env, ref_seed, dev)
            else:
                ref_batch = collect_ref_batch(env, torch.Generator(device=dev).manual_seed(ref_seed), dev)
        return replay_policy(
            model, theta, env, episodes=episodes, save_frames=save_frames, seed=seed, ref_batch=ref_batch,
            return_trajectory=return_trajectory, device=dev,
        )
    finally:
        if getattr(env, "is_host_env", False):
            env.close()
