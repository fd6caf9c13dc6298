"""Lockstep population rollouts on a device env.

The counterpart of the JAX package's algos/rollout.py ``rollout_batch`` and
``collect_ref_batch``. One loop steps all B env slots and all B per-member
policies together on the device: observe → population forward → env step
→ reward, length and obs-stat accounting, with no host engine. A slot that
is done is frozen by a mask (``_mask_tree``), as in the JAX package's
``lax.while_loop``.

That loop ends once ``t`` reaches the limit or every slot is done. Here
the "every slot is done" test reads the device, so it runs once every
``CHECK_EVERY`` steps: a step after all slots are done changes nothing (its
rewards, lengths, obs sums and states are masked), so the results are those
of a test at every step, for one host sync per ``CHECK_EVERY`` steps.

On a CUDA device those ``CHECK_EVERY`` steps run as one CUDA graph: a step
is a few hundred small kernels, whose launches from the host took ten
times their device time on an H100 (PERF.md). The first chunk of steps runs
eagerly (it warms the libraries up), the next is captured once into a
graph that updates the loop's tensors in place, and every later full chunk
replays it; the steps past the last full chunk run eagerly. The kernels are
those of the eager loop, so the results are too (``chip_smoke.py`` holds
the two against each other on the card). A model that draws random numbers
in a step does so from the context's generator (models/mlp.py), which the
graph registers so that each replay draws afresh.

The caller hands in the slots' reset state (``env.reset``; antithetic pairs
start from the same state, see ``paired_reset``), so tests can feed the
JAX package's reset states in.

Not ported yet: ``rollout_batch_scan`` (per-step trajectories, used by the
JAX package's utils/viz.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..envs.core import Env

CHECK_EVERY = 8  # steps between the host's reads of "every slot done"


class RolloutResult(NamedTuple):
    returns: torch.Tensor  # [B] f32 undiscounted episode return
    sign_returns: torch.Tensor  # [B] f32 Σ sign(r_t) (es.py:283-287)
    lengths: torch.Tensor  # [B] int32 steps taken, the terminal one included
    bc: torch.Tensor  # [B, bc_dim] f32 final-state behavior characterization
    ob_sum: torch.Tensor  # [obs_shape] f32 obs-stat sums over the counted steps
    ob_sumsq: torch.Tensor
    ob_count: torch.Tensor  # scalar f32


def _mask_tree(done: torch.Tensor, old, new):
    """State fields of finished slots stay at ``old``: done is [B], every
    field [B, ...]."""
    return type(old)(*(
        torch.where(done.reshape(done.shape + (1,) * (o.ndim - 1)), o, n) for o, n in zip(old, new)
    ))


def index_state(state, idx: torch.Tensor):
    """The slots ``idx`` of a batched state."""
    return type(state)(*(f[idx] for f in state))


def paired_reset(env: Env, npairs: int, gen: torch.Generator, device) -> tuple:
    """Reset states for ``2·npairs`` slots whose halves start alike: slot i
    and slot npairs + i (θ+σε and θ−σε) share one draw, as the JAX
    package's antithetic pairs share their episode key (es.py:189)."""
    state = env.reset(npairs, gen, device)
    idx = torch.arange(npairs, device=state[0].device)
    return index_state(state, torch.cat([idx, idx]))


class _Carry(NamedTuple):
    state: tuple  # the env's state NamedTuple
    done: torch.Tensor  # [B] bool
    ret: torch.Tensor  # [B] f32
    sret: torch.Tensor  # [B] f32
    length: torch.Tensor  # [B] int32
    ob_sum: torch.Tensor
    ob_sumsq: torch.Tensor
    ob_count: torch.Tensor


def _leaves(c: _Carry) -> list:
    return [*c.state, *c[1:]]


def _step(env: Env, act_fn: Callable, params, c: _Carry, collect_obstat: bool, obstat_mask) -> _Carry:
    """One lockstep step of every slot; finished slots change nothing."""
    obs = env.observe(c.state)
    actions = act_fn(params, obs)
    nstate, r, d = env.step(c.state, actions)
    alive = torch.logical_not(c.done).to(torch.float32)
    ob_sum, ob_sumsq, ob_count = c.ob_sum, c.ob_sumsq, c.ob_count
    if collect_obstat:
        sel = alive if obstat_mask is None else alive * obstat_mask
        m = sel.reshape((sel.shape[0],) + (1,) * (obs.ndim - 1))
        ob_sum = ob_sum + torch.sum(obs * m, dim=0)
        ob_sumsq = ob_sumsq + torch.sum(obs * obs * m, dim=0)
        ob_count = ob_count + torch.sum(sel)
    return _Carry(
        _mask_tree(c.done, c.state, nstate), c.done | d, c.ret + r * alive, c.sret + torch.sign(r) * alive,
        c.length + alive.to(torch.int32), ob_sum, ob_sumsq, ob_count,
    )


def _capture(step: Callable, c: _Carry, k: int, gen: Optional[torch.Generator]):
    """(carry, replay): a CUDA graph of ``k`` steps from a copy of ``c``
    that writes each result back into that copy, so every ``replay()``
    advances the returned carry by ``k`` steps. Capturing runs nothing."""
    c = _Carry(type(c.state)(*(x.clone() for x in c.state)), *(x.clone() for x in c[1:]))
    graph = torch.cuda.CUDAGraph()
    if gen is not None:
        graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = c
        for _ in range(k):
            out = step(out)
        for dst, src in zip(_leaves(c), _leaves(out)):
            dst.copy_(src)
    return c, graph.replay


def rollout_batch(
    env: Env,
    act_fn: Callable,  # (params, obs [B, ...]) -> actions [B, ...]
    params,  # (thetas [B, D] or prepared parts, ctx)
    state,  # the B slots' reset state
    timestep_limit: int,
    collect_obstat: bool = False,
    obstat_mask: Optional[torch.Tensor] = None,  # [B] 0/1: which rollouts join the obs stats
) -> RolloutResult:
    """One episode on each of B slots, each slot with its own member."""
    prep = getattr(act_fn, "prepare", None)
    if prep is not None:
        params = prep(params)  # unflatten once, outside the step loop
    B, device = state[0].shape[0], state[0].device
    zeros = lambda shape, dtype=torch.float32: torch.zeros(shape, dtype=dtype, device=device)  # noqa: E731
    c = _Carry(state, zeros(B, torch.bool), zeros(B), zeros(B), zeros(B, torch.int32), zeros(env.obs_shape),
               zeros(env.obs_shape), zeros(()))

    def step(c):
        return _step(env, act_fn, params, c, collect_obstat, obstat_mask)

    t, replay = 0, None
    while t < timestep_limit:
        k = min(CHECK_EVERY, timestep_limit - t)
        if replay is not None and k == CHECK_EVERY:
            replay()
        elif device.type == "cuda" and t > 0 and timestep_limit - t >= 2 * CHECK_EVERY:
            c, replay = _capture(step, c, CHECK_EVERY, getattr(params[1], "gen", None))
            continue  # the first replay runs these steps
        else:
            for _ in range(k):
                c = step(c)
        t += k
        if bool(c.done.all()):
            break
    bc = env.behavior(c.state) if env.bc_dim else zeros((B, 0))
    return RolloutResult(c.ret, c.sret, c.length, bc, c.ob_sum, c.ob_sumsq, c.ob_count)


def random_actions(env: Env, n: int, gen: torch.Generator, device) -> torch.Tensor:
    """Uniform random actions for ``n`` slots: integers in [0, n_actions)
    for a discrete space, floats in [-0.5, 0.5) per dimension otherwise."""
    if env.discrete_action:
        a = torch.randint(0, env.action_space.n, (n,), generator=gen, device=gen.device)
    else:
        a = torch.rand((n, env.action_space.dim), generator=gen, device=gen.device) - 0.5
    return a.to(device)


def collect_ref_batch(env: Env, gen: torch.Generator, device, batch_size: int = 128, slots: int = 8) -> torch.Tensor:
    """Observations of a random policy, for virtual batch norm
    (gym_tensorflow/__init__.py:17-37 get_ref_batch; es_distributed/
    es.py:106-113): ``slots`` envs step ⌈batch_size/slots⌉ times with
    uniform random actions, a finished slot restarting from a fresh reset;
    returns ``[batch_size, *obs_shape]``, the observations after each step."""
    steps = -(-batch_size // slots)
    state = env.reset(slots, gen, device)
    out = []
    for _ in range(steps):
        nstate, _, d = env.step(state, random_actions(env, slots, gen, device))
        state = _mask_tree(d, env.reset(slots, gen, device), nstate)  # finished slots restart
        out.append(env.observe(state))
    return torch.cat(out)[:batch_size]
