"""Rollouts on the host engine: C++ simulators on the host, preprocessing and
the population forward on the device.

The counterpart of the JAX package's algos/rollout_host.py
``rollout_host_batch`` and ``collect_ref_batch_host`` for gray frames. Each
engine step of a slot group: gray frame pairs → 2-frame max and resize →
4-stack → population forward → argmax → C++ step of the slots still
running.

Host/device overlap: the slots are split into ``pipeline_groups``
interleaved groups. PyTorch queues a group's device work and returns, so
the engine steps the next group while the device computes this group's
actions; reading a group's actions is the only wait. Per-slot results do
not depend on the group count.

Randomness comes from one integer ``seed``: it seeds a NumPy generator that
draws the noop counts and the engine's per-episode seeds, in the same
order as the JAX package, so equal seeds give equal episodes in both.

``n_slots`` runs only slots ``[0, n)``; each result carries the slots'
final states (RAM bytes) as their behavior characterization and, with
``collect_bc_traj``, each slot's RAM after every step it took, the
trajectory BC of NS-ES on Atari (policies.py:410-418). The RAM is read
after each whole step, every group's engine step done.

Not ported yet: obs-stat sampling, mirrored pairs,
``rollout_host_vec`` (vector-observation engines) and the ``rollout_host``
dispatcher between it and ``rollout_host_batch``; overlap through a second
CUDA stream.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..envs.preprocess import preprocess_gray_frames, stack_reset, stack_step


class RolloutResult(NamedTuple):
    returns: np.ndarray  # [B] f32 undiscounted episode return
    sign_returns: np.ndarray  # [B] f32 Σ sign(r_t)
    lengths: np.ndarray  # [B] i32 engine steps taken, the terminal one included
    bc: np.ndarray  # [B, final_state_size] f32 final RAM bytes (tf_atari.cpp:114-119)
    # with collect_bc_traj: per slot, its RAM after each step it took,
    # concatenated, [length · final_state_size] f32; ragged across slots
    bc_traj: Optional[Tuple[np.ndarray, ...]] = None


def _frames_to(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(frames).to(device, non_blocking=True)


def _slice_params(params, sl: slice):
    """One group's ``(thetas [Bg, D], stats)``: every stats leaf is per
    member ``[B, ...]``."""
    thetas, stats = params
    if stats is not None:
        stats = type(stats)(*(tuple(leaf[sl] for leaf in field) for field in stats))
    return thetas[sl], stats


def rollout_host_batch(
    henv,
    act_fn: Callable,
    params,
    seed: int,
    timestep_limit: int,
    device: torch.device,
    pipeline_groups: Optional[int] = None,
    n_slots: Optional[int] = None,
    collect_bc_traj: bool = False,
) -> RolloutResult:
    """Evaluate B policies on the B engine slots, one episode each.

    ``params`` is ``(thetas [B, D], stats)`` on ``device``. ``timestep_limit``
    counts engine steps (each is 4 emulator frames). ``pipeline_groups``
    defaults to the env's. ``n_slots`` < B runs only slots ``[0, n_slots)``
    with n_slots policies (the GA's validation and test ladder evaluates a
    handful of members). ``collect_bc_traj`` returns each slot's RAM
    trajectory in ``bc_traj``."""
    B, out_hw = henv.batch_size, henv.warp_size
    sub = None
    if n_slots is not None and n_slots < B:
        B = max(int(n_slots), 1)
        sub = np.arange(B, dtype=np.int32)
    G = pipeline_groups if pipeline_groups is not None else getattr(henv, "pipeline_groups", 1)
    if G < 1 or B % G != 0:
        G = 1
    Bg = B // G
    rng = np.random.default_rng(seed)
    noops = rng.integers(1, 31, size=B)  # tf_atari.py:65
    # fresh engine episode seeds on every call, drawn after the noops
    ep_seeds = rng.integers(1, 2**31 - 1, size=B, dtype=np.int64).astype(np.int32)
    henv.reset(noops, indices=sub, max_frames=timestep_limit * 4, seeds=ep_seeds)

    frames0 = henv.observe(indices=sub)
    sls = [slice(g * Bg, (g + 1) * Bg) for g in range(G)]
    gidx = [np.arange(g * Bg, (g + 1) * Bg, dtype=np.int32) for g in range(G)]
    params_g = [act_fn.prepare(_slice_params(params, s)) for s in sls]
    stacks = [
        stack_reset(preprocess_gray_frames(_frames_to(frames0[s], device), out_hw, out_hw)) for s in sls
    ]
    actions_dev = [act_fn(params_g[g], stacks[g]) for g in range(G)]

    done = np.zeros(B, bool)
    ret = np.zeros(B, np.float32)
    sret = np.zeros(B, np.float32)
    length = np.zeros(B, np.int32)
    rams, ram_slots = [], []  # per step: the RAM rows of the slots that took it, and their slots
    for _ in range(timestep_limit):
        if done.all():
            break
        alive_t = np.nonzero(~done)[0]  # the slots taking this step
        for g in range(G):
            galive = ~done[sls[g]]
            if not galive.any():
                continue
            with record_function("rollout.wait_actions"):
                acts = actions_dev[g].cpu().numpy()  # waits for this group only
            alive_idx = gidx[g][galive]
            with record_function("rollout.engine"):
                r_sub, d_sub = henv.step(acts[galive], indices=alive_idx)
                frames_g = henv.observe(indices=gidx[g])
            # queued on the device; the next group's engine step overlaps it
            with record_function("rollout.queue_forward"):
                obs = preprocess_gray_frames(_frames_to(frames_g, device), out_hw, out_hw)
                stacks[g] = stack_step(stacks[g], obs)
                actions_dev[g] = act_fn(params_g[g], stacks[g])
            ret[alive_idx] += r_sub
            sret[alive_idx] += np.sign(r_sub)
            length[alive_idx] += 1
            done[alive_idx] |= d_sub
        if collect_bc_traj:
            rams.append(henv.final_state(indices=sub)[alive_t])
            ram_slots.append(alive_t)
    trajs = None
    if collect_bc_traj:
        # a slot took steps 0 … length−1: its rows, in step order, are its
        # trajectory
        rows = np.zeros(0, np.float32)
        if rams:
            rows = np.concatenate(rams)[np.argsort(np.concatenate(ram_slots), kind="stable")]
        trajs = tuple(t.reshape(-1) for t in np.split(rows, np.cumsum(length)[:-1]))
    return RolloutResult(ret, sret, length, henv.final_state(indices=sub), trajs)


def collect_ref_batch_host(henv, seed: int, device: torch.device, batch_size: int = 128) -> torch.Tensor:
    """Stacked observations ``[batch_size, 84, 84, 4]`` of a random policy,
    the VBN reference batch (gym_tensorflow/__init__.py:17-37)."""
    B, out_hw = henv.batch_size, henv.warp_size
    rng = np.random.default_rng(seed)
    henv.reset(rng.integers(1, 31, size=B))
    stack = stack_reset(preprocess_gray_frames(_frames_to(henv.observe(), device), out_hw, out_hw))
    collected, n = [], 0
    while n < batch_size:
        acts = rng.integers(0, henv.num_actions, size=B).astype(np.int32)
        _, d = henv.step(acts)
        obs = preprocess_gray_frames(_frames_to(henv.observe(), device), out_hw, out_hw)
        stack = stack_step(stack, obs)
        collected.append(stack)
        n += B
        if d.any():  # restart finished slots so frames keep flowing
            idx = np.nonzero(d)[0].astype(np.int32)
            henv.reset(rng.integers(1, 31, size=idx.size), indices=idx)
    return torch.cat(collected)[:batch_size]
