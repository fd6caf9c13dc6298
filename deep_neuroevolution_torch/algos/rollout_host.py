"""Rollouts on the host engine: C++ simulators on the host, preprocessing and
the population forward on the device.

The counterpart of the JAX package's algos/rollout_host.py
``rollout_host_batch`` and ``collect_ref_batch_host``. Each engine step of a
slot group: the engine's frames of the env's ``obs_mode`` → the device's
part of the preprocessing (envs/preprocess.py ``preprocess_obs``: palette,
2-frame max and resize for 'indexed', max and resize for 'gray', a scale
for 'preproc') → 4-stack → population forward → argmax → C++ step of the
slots still running.

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

``mirror_pairs = n`` (ES's ``mirror_crn``) makes slot i and slot n + i
share their noop count and engine episode seed: mirrored sampling with
common random numbers for a round of n antithetic pairs laid out as
[θ+σε block; θ−σε block]. The draws are the JAX package's where 2n is the
slot count; where the round is padded (2n < slots) the pad slots take the
last pair's draws. Each result carries its slots' engine episode seeds.

Obs stats (``collect_obstat``): the observations each slot acted on, summed
over the slots still running (``ob_sum``, ``ob_sumsq`` and ``ob_count`` of
the result, float32 on the host). With ``obstat_prob`` each rollout joins
with that probability, one Bernoulli draw a slot from the host generator
in the JAX package's order (es.py:356-363: the reference's worker draws
once a rollout); ``obstat_valid`` then leaves out the slots that are False
in it (a round's padded copies), after the draw, so the other draws do not
move.

``rollout_host_vec`` is the vector-observation engines' rollout (MuJoCo,
envs/mujoco.py): the raw ``[B, obs_dim]`` float32 observations are
uploaded each step and go straight into the population forward, with no
preprocessing or stack; the episode is clamped to the env's
``max_episode_steps`` (policies.py:264-265), the obs stats sum the raw
observations (policies.py:279-281), and the behavior characterization is
the env's ``final_state``. ``rollout_host`` dispatches on the env's
``host_obs``. A model that draws action noise draws it from its context's
generator, every slot its own draws (the JAX package gives every slot its
own key, rollout_host.py:320-325). With ``vec_timings`` set to a dict, the
vector rollout syncs the device around its upload, forward and engine
step and adds their seconds there (a measurement harness sets it; a run
does not pay for the syncs).

Spans (utils/trace.py), recorded only while a profiler runs: each group's
step of ``rollout_host_batch`` is ``rollout.wait_actions``,
``rollout.engine`` and ``rollout.queue_forward``, the last holding the
preprocessing's ``preprocess.*`` and the forward's ``model.*`` spans;
each step of ``rollout_host_vec`` is ``rollout.upload``,
``rollout.forward`` and ``rollout.engine``.

Not ported: overlap through a second CUDA stream.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..envs.preprocess import preprocess_obs, stack_reset, stack_step
from ..utils.trace import span


class RolloutResult(NamedTuple):
    returns: np.ndarray  # [B] f32 undiscounted episode return
    sign_returns: np.ndarray  # [B] f32 Σ sign(r_t)
    lengths: np.ndarray  # [B] i32 engine steps taken, the terminal one included
    # [B, bc_dim] f32: final RAM bytes (tf_atari.cpp:114-119), or a vector
    # engine's final_state (the mass centre)
    bc: np.ndarray
    # with collect_bc_traj: per slot, its RAM after each step it took,
    # concatenated, [length · final_state_size] f32; ragged across slots
    bc_traj: Optional[Tuple[np.ndarray, ...]] = None
    ep_seeds: Optional[np.ndarray] = None  # [B] i32 the engine episode seed of each slot
    # with collect_obstat: [obs_shape] f32 sums of the counted observations
    # and of their squares, and their count
    ob_sum: Optional[np.ndarray] = None
    ob_sumsq: Optional[np.ndarray] = None
    ob_count: float = 0.0


# a dict makes rollout_host_vec sync and time its parts (see the module docstring)
vec_timings: Optional[dict] = None


def _frames_to(frames: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(frames).to(device, non_blocking=True)


def _obs(henv, frames: np.ndarray, device: torch.device) -> torch.Tensor:
    """The engine's frames → one observation ``[n, 84, 84, 1]`` on the device."""
    return preprocess_obs(_frames_to(frames, device), henv.obs_mode, henv.warp_size, henv.warp_size)


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
    mirror_pairs: int = 0,
    collect_obstat: bool = False,
    obstat_prob: Optional[float] = None,
    obstat_valid: Optional[np.ndarray] = None,
) -> RolloutResult:
    """Evaluate B policies on the B engine slots, one episode each.

    ``params`` is ``(thetas [B, D], stats)`` on ``device``. ``timestep_limit``
    counts engine steps (each is 4 emulator frames). ``pipeline_groups``
    defaults to the env's. ``n_slots`` < B runs only slots ``[0, n_slots)``
    with n_slots policies (the GA's validation and test ladder evaluates a
    handful of members). ``collect_bc_traj`` returns each slot's RAM
    trajectory in ``bc_traj``. ``mirror_pairs`` > 0 is the round's pair
    count for mirrored draws; ``collect_obstat``, ``obstat_prob`` and
    ``obstat_valid`` [B] the obs stats (see the module docstring)."""
    B = henv.batch_size
    sub = None
    if n_slots is not None and n_slots < B:
        B = max(int(n_slots), 1)
        sub = np.arange(B, dtype=np.int32)
    G = pipeline_groups if pipeline_groups is not None else getattr(henv, "pipeline_groups", 1)
    if G < 1 or B % G != 0:
        G = 1
    Bg = B // G
    rng = np.random.default_rng(seed)
    if mirror_pairs:
        n = int(mirror_pairs)
        if not 0 < 2 * n <= B:
            raise ValueError(f"mirror_pairs={n} pairs do not fit {B} slots")
        # slot i and n + i take draw i; pad slots the last pair's
        draw = np.concatenate([np.arange(n), np.arange(n), np.full(B - 2 * n, n - 1)])
        noops = rng.integers(1, 31, size=n)[draw]
        ep_seeds = rng.integers(1, 2**31 - 1, size=n, dtype=np.int64).astype(np.int32)[draw]
        obstat_mask = _obstat_mask(rng, B, collect_obstat, obstat_prob, obstat_valid)
    else:
        noops = rng.integers(1, 31, size=B)  # tf_atari.py:65
        obstat_mask = _obstat_mask(rng, B, collect_obstat, obstat_prob, obstat_valid)
        # fresh engine episode seeds on every call, drawn after the noops
        # and the obs-stat draws (the JAX package's order)
        ep_seeds = rng.integers(1, 2**31 - 1, size=B, dtype=np.int64).astype(np.int32)
    henv.reset(noops, indices=sub, max_frames=timestep_limit * 4, seeds=ep_seeds)

    frames0 = henv.observe(indices=sub)
    sls = [slice(g * Bg, (g + 1) * Bg) for g in range(G)]
    gidx = [np.arange(g * Bg, (g + 1) * Bg, dtype=np.int32) for g in range(G)]
    params_g = [act_fn.prepare(_slice_params(params, s)) for s in sls]
    stacks = [stack_reset(_obs(henv, frames0[s], device)) for s in sls]
    actions_dev = [act_fn(params_g[g], stacks[g]) for g in range(G)]

    done = np.zeros(B, bool)
    ret = np.zeros(B, np.float32)
    sret = np.zeros(B, np.float32)
    length = np.zeros(B, np.int32)
    ob_sum = ob_sumsq = None
    ob_count = 0.0
    if collect_obstat:
        ob_sum, ob_sumsq = np.zeros(henv.obs_shape, np.float32), np.zeros(henv.obs_shape, np.float32)
    rams, ram_slots = [], []  # per step: the RAM rows of the slots that took it, and their slots
    for _ in range(timestep_limit):
        if done.all():
            break
        alive_t = np.nonzero(~done)[0]  # the slots taking this step
        for g in range(G):
            galive = ~done[sls[g]]
            if not galive.any():
                continue
            with span("rollout.wait_actions"):
                acts = actions_dev[g].cpu().numpy()  # waits for this group only
            alive_idx = gidx[g][galive]
            if collect_obstat:  # the stacks this step's actions came from
                s_np = stacks[g].cpu().numpy()
                gmask = galive & obstat_mask[sls[g]]
                ob_sum += s_np[gmask].sum(axis=0)
                ob_sumsq += np.square(s_np[gmask]).sum(axis=0)
                ob_count += float(gmask.sum())
            with span("rollout.engine"):
                r_sub, d_sub = henv.step(acts[galive], indices=alive_idx)
                frames_g = henv.observe(indices=gidx[g])
            # queued on the device; the next group's engine step overlaps it
            with span("rollout.queue_forward"):
                stacks[g] = stack_step(stacks[g], _obs(henv, frames_g, device))
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
    return RolloutResult(ret, sret, length, henv.final_state(indices=sub), trajs, ep_seeds, ob_sum, ob_sumsq,
                         ob_count)


def _obstat_mask(rng, B: int, collect: bool, prob: Optional[float], valid: Optional[np.ndarray]) -> np.ndarray:
    """The slots whose observations join the obs stats: a Bernoulli draw a
    slot when ``prob`` is given (es.py:356-363), ANDed with ``valid`` after
    the draw."""
    mask = rng.random(B) < prob if (collect and prob is not None) else np.ones(B, bool)
    if valid is not None:
        mask &= np.asarray(valid, bool)[:B]
    return mask


def _timed(key: str, device: torch.device):
    """A context that adds its seconds to ``vec_timings[key]``, the device
    synced at both ends, when ``vec_timings`` is a dict; else nothing."""
    timings = vec_timings
    if timings is None:
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def timed():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0

    return timed()


def rollout_host_vec(
    henv,
    act_fn: Callable,
    params,
    seed: int,
    timestep_limit: int,
    device: torch.device,
    collect_obstat: bool = False,
    obstat_prob: Optional[float] = None,
    obstat_valid: Optional[np.ndarray] = None,
    n_slots: Optional[int] = None,
) -> RolloutResult:
    """Evaluate B policies on the B slots of a vector engine, one episode
    each (the JAX package's ``rollout_host_vec``; MujocoPolicy.rollout,
    policies.py:258-302): each step the raw observations ``[B, obs_dim]``
    f32 go to the device, the population forward picks every slot's action,
    and the slots still running step. ``params`` is ``(thetas [B, D],
    ctx)``. The episode ends at ``min(timestep_limit, max_episode_steps)``.
    From ``seed``'s generator: the obs-stat draws, then every slot's episode
    seed (the JAX package's order)."""
    B = henv.batch_size
    sub = None
    if n_slots is not None and n_slots < B:
        B = max(int(n_slots), 1)
        sub = np.arange(B, dtype=np.int32)
    params = act_fn.prepare(params)
    tslimit = min(int(timestep_limit), getattr(henv, "max_episode_steps", timestep_limit))
    rng = np.random.default_rng(seed)
    obstat_mask = _obstat_mask(rng, B, collect_obstat, obstat_prob, obstat_valid)
    ep_seeds = rng.integers(0, 2**31 - 1, size=B)
    henv.reset(indices=sub, seeds=ep_seeds)

    done = np.zeros(B, bool)
    ret = np.zeros(B, np.float32)
    sret = np.zeros(B, np.float32)
    length = np.zeros(B, np.int32)
    ob_sum = ob_sumsq = None
    ob_count = 0.0
    if collect_obstat:
        ob_sum, ob_sumsq = np.zeros(henv.obs_shape, np.float32), np.zeros(henv.obs_shape, np.float32)
    obs = henv.observe()[:B]
    t = 0
    while not done.all() and t < tslimit:
        with span("rollout.upload"), _timed("upload", device):
            obs_dev = torch.from_numpy(obs).to(device)  # a synchronous copy: the engine rewrites obs next step
        with span("rollout.forward"), _timed("forward", device):
            actions = act_fn(params, obs_dev).cpu().numpy()  # the only wait for the device
        alive_idx = np.nonzero(~done)[0].astype(np.int32)
        if collect_obstat:  # the raw observations the slots acted on (policies.py:279-281)
            oidx = np.nonzero(~done & obstat_mask)[0]
            ob_sum += obs[oidx].sum(axis=0)
            ob_sumsq += np.square(obs[oidx]).sum(axis=0)
            ob_count += float(oidx.size)
        with span("rollout.engine"), _timed("env_step", device):
            r_sub, d_sub = henv.step(actions[alive_idx], indices=alive_idx)
            obs = henv.observe()[:B]
        ret[alive_idx] += r_sub
        sret[alive_idx] += np.sign(r_sub)
        length[alive_idx] += 1
        done[alive_idx] |= d_sub
        t += 1
    if vec_timings is not None:
        vec_timings["steps"] = vec_timings.get("steps", 0) + t
        vec_timings["slot_steps"] = vec_timings.get("slot_steps", 0) + int(length.sum())
    return RolloutResult(ret, sret, length, henv.final_state()[:B], None, ep_seeds.astype(np.int32), ob_sum, ob_sumsq,
                         ob_count)


def rollout_host(
    henv,
    act_fn: Callable,
    params,
    seed: int,
    timestep_limit: int,
    device: torch.device,
    collect_obstat: bool = False,
    collect_bc_traj: bool = False,
    obstat_prob: Optional[float] = None,
    obstat_valid: Optional[np.ndarray] = None,
    n_slots: Optional[int] = None,
    mirror_pairs: int = 0,
) -> RolloutResult:
    """``rollout_host_vec`` on a vector engine (``host_obs == "vector"``,
    MuJoCo), else ``rollout_host_batch`` (the Atari engine, preprocessing
    and the stack on the device). A vector engine has no per-step RAM
    trajectory and no mirrored draws: asked for either, it raises (the JAX
    package ignores them there)."""
    if getattr(henv, "host_obs", "image") == "vector":
        if collect_bc_traj or mirror_pairs:
            raise ValueError("a vector engine has no per-step RAM trajectory and no mirrored draws "
                             "(collect_bc_traj, mirror_pairs)")
        return rollout_host_vec(henv, act_fn, params, seed, timestep_limit, device, collect_obstat=collect_obstat,
                                obstat_prob=obstat_prob, obstat_valid=obstat_valid, n_slots=n_slots)
    return rollout_host_batch(henv, act_fn, params, seed, timestep_limit, device, n_slots=n_slots,
                              collect_bc_traj=collect_bc_traj, mirror_pairs=mirror_pairs,
                              collect_obstat=collect_obstat, obstat_prob=obstat_prob, obstat_valid=obstat_valid)


def collect_ref_batch_host(henv, seed: int, device: torch.device, batch_size: int = 128) -> torch.Tensor:
    """Stacked observations ``[batch_size, 84, 84, 4]`` of a random policy,
    the VBN reference batch (gym_tensorflow/__init__.py:17-37)."""
    B = henv.batch_size
    rng = np.random.default_rng(seed)
    henv.reset(rng.integers(1, 31, size=B))
    stack = stack_reset(_obs(henv, henv.observe(), device))
    collected, n = [], 0
    while n < batch_size:
        acts = rng.integers(0, henv.num_actions, size=B).astype(np.int32)
        _, d = henv.step(acts)
        stack = stack_step(stack, _obs(henv, henv.observe(), device))
        collected.append(stack)
        n += B
        if d.any():  # restart finished slots so frames keep flowing
            idx = np.nonzero(d)[0].astype(np.int32)
            henv.reset(rng.integers(1, 31, size=idx.size), indices=idx)
    return torch.cat(collected)[:batch_size]
