"""Pod ES on device envs: a generation's rounds split over the ranks, the
fitness columns gathered, the gradient summed across ranks.

The counterpart of the JAX package's parallel/es_pod.py. The JAX package
runs a generation as one ``shard_map``'d program; the port keeps the
single-device trainer's steps (algos/es.py: ``_device_round`` with its
8-step CUDA graphs, ``_device_eval``, the update) and changes only how a
round's rows are split and how the columns and sums come back:

* ``device_rounds`` (``make_pod_es_step``'s and ``make_pod_eval_rounds``'s
  rounds): a global round is ``size`` blocks of ``npairs`` pairs, block p
  evaluated by rank p, every block's draws made on every rank; in quota
  mode the rounds both quotas need are estimated from the gathered lengths
  of the last dispatch, as the single trainer does (es.py:230-265);
* ``partial_gradient`` (``make_pod_update_eval``'s update, es_pod.py:202-
  213): the rank transform runs on the global columns, each rank sums
  wᵢ·εᵢ over its own rows with K2, and the partial sums are added across
  ranks; the obs-stat moments are summed too (trainers.py:148-153);
* ``eval_split``: the eval episodes, ⌈n / size⌉ a rank from the single
  trainer's reset states (trainers.py:186-188);
* ``npairs_per_rank``: ``eval_batch`` counts pairs per rank
  (trainers.py:176-185).

``run_blocks`` and ``gather_column`` are the block plumbing that the GA
and NS-ES pods share.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .mesh import interleave


def run_blocks(tr, n_rounds: int, draw: Callable, run: Callable):
    """``n_rounds`` global rounds of ``size`` blocks: every rank makes each
    block's draws (``draw()``), in round-major order, and rank p runs block
    (r, p) (``run(draws)``) on its own engine. Returns (the draws of every
    block in that order, {rank: [its blocks' results, round by round]})."""
    draws, out = [], {p: [] for p in tr.pod.pids}
    for _ in range(n_rounds):
        for p in range(tr.pod.size):
            d = draw()
            draws.append(d)
            if p in out:
                with tr._on_rank(p):
                    out[p].append(run(d))
    return draws, out


def _cat(parts: List):
    return np.concatenate(parts) if isinstance(parts[0], np.ndarray) else torch.cat(parts)


def gather_column(tr, out: Dict[int, list], i: int, n_rounds: int):
    """Column ``i`` of every block, gathered across the ranks, in the
    blocks' draw order."""
    parts = [_cat([res[i] for res in out[p]]) for p in tr.pod.pids]
    return interleave(tr.pod.gather(parts), tr.pod.size, n_rounds)


def local_sum(tr, out: Dict[int, list], i: int):
    """Each rank's sum of column ``i`` over its blocks (in round order),
    summed across ranks."""
    if out[tr.pod.pids[0]][0][i] is None:
        return None
    return tr.pod.sum([sum(res[i] for res in out[p]) for p in tr.pod.pids])


def block_rows(size: int, n_blocks: int, rows: int, first: int = 0) -> Dict[int, np.ndarray]:
    """The global rows of each rank's blocks: block b (draw order) covers
    ``first + [b·rows, (b+1)·rows)`` and belongs to rank b mod size."""
    return {p: first + np.concatenate([np.arange(b * rows, (b + 1) * rows) for b in range(p, n_blocks, size)]
                                      or [np.zeros(0, np.int64)]) for p in range(size)}


def npairs_per_rank(tr) -> int:
    """Pairs a rank's block evaluates (the JAX package's trainers.py:176-
    185): ``eval_batch`` when set, else the population's share of a rank,
    or 64 in quota mode, capped so the ``[2·pairs, D]`` θ batch stays under
    ``theta_hbm_budget``."""
    cfg = tr.config
    cap = max(1, int(cfg.theta_hbm_budget) // (2 * tr.model.num_params * 4))
    if cfg.eval_batch:
        return min(cfg.eval_batch, cap)
    if cfg.population_size:
        return min(max(cfg.population_size // (2 * tr.pod.size), 1), cap)
    return min(64, cap)


def _dispatch(tr, npairs: int, n_rounds: int, obstat_prob: Optional[float]) -> dict:
    """``n_rounds`` global rounds of ``_device_round``s; the columns
    gathered in draw order, the obs-stat moments summed."""
    draws, out = run_blocks(tr, n_rounds, lambda: tr._draw_round(npairs),
                            lambda d: tr._device_round(npairs, obstat_prob, d))
    rets, srets, lens, bcs = (gather_column(tr, out, i, n_rounds) for i in range(1, 5))
    return dict(
        idxs=torch.cat([d[0] for d in draws]), rets=rets, srets=srets, lens=lens, bcs=bcs,
        ob=tuple(local_sum(tr, out, i) for i in (5, 6, 7)),
        seeds=np.repeat(np.array([d[1] for d in draws], np.int64), npairs), blocks=len(draws),
    )


def device_rounds(tr, npairs: int, obstat_prob: Optional[float]) -> list:
    """A generation's rounds (the single trainer's ``_device_rounds``), as
    one round of the gathered global columns whose rollout seeds are one a
    pair; sets ``tr._rows``, each rank's global rows, for the gradient."""
    cfg, size = tr.config, tr.pod.size
    if not tr.quota_mode:
        pop = cfg.population_size
        per_rank = -(-max(pop // 2, 1) // size) if pop else npairs
        npairs = min(npairs, per_rank)
        batches = [_dispatch(tr, npairs, -(-per_rank // npairs), obstat_prob)]
    else:  # the JAX package's quota loop over global rounds (trainers.py:221-262)
        batches, episodes, timesteps = [], 0, 0
        tr.last_dispatches = []
        per_round = 2 * npairs * size
        while True:
            rem_ep = max(cfg.episodes_per_batch - episodes, 0)
            rem_ts = max(cfg.timesteps_per_batch - timesteps, 0)
            r_ep = -(-rem_ep // per_round) if rem_ep else 0
            r_ts = -(-rem_ts // int(per_round * max(tr._mean_len_est, 1.0))) if rem_ts else 0
            n = max(r_ep, r_ts, 1 if episodes == 0 else 0)
            if n == 0:
                break
            b = _dispatch(tr, npairs, n, obstat_prob)
            batches.append(b)
            tr.last_dispatches.append(n)
            episodes += b["lens"].numel()
            timesteps += int(b["lens"].sum())
            tr._mean_len_est = max(float(b["lens"].double().mean()), 1.0)
            if tr._quotas_met(episodes, timesteps):
                break
    rows, first = {p: [] for p in range(size)}, 0
    for b in batches:
        for p, r in block_rows(size, b["blocks"], npairs, first).items():
            rows[p].append(r)
        first += b["blocks"] * npairs
    dev = tr.device
    tr._rows = [torch.as_tensor(np.concatenate(rows[p]), device=dev) for p in tr.pod.pids]
    cat = lambda k: torch.cat([b[k] for b in batches])  # noqa: E731
    ob = [sum(b["ob"][i] for b in batches) if batches[0]["ob"][i] is not None else None for i in range(3)]
    return [(cat("idxs"), cat("rets"), cat("srets"), cat("lens"), cat("bcs"), *ob,
             np.concatenate([b["seeds"] for b in batches]))]


def partial_gradient(tr, idxs: torch.Tensor, w: torch.Tensor, gradient: Callable) -> torch.Tensor:
    """Σᵢ wᵢ·εᵢ: each rank's sum over its own rows (``gradient``, K2 on a
    table), added across the ranks (es_pod.py:202-213)."""
    return tr.pod.sum([gradient(idxs[rows], w[rows]) for rows in tr._rows])


def eval_split(tr, seed: int, run: Callable):
    """The generation's ``num_eval_episodes`` eval episodes, rank p's block
    of ⌈n / size⌉ run by ``run(seed, (lo, hi))`` from the single trainer's
    reset states, gathered in episode order."""
    n, pod = tr.config.num_eval_episodes, tr.pod
    counts = [hi - lo for lo, hi in (pod.block(n, p) for p in range(pod.size))]
    parts = []
    for p in pod.pids:
        lo, hi = pod.block(n, p)
        if hi > lo:
            parts.append(run(seed, (lo, hi)))
        else:  # an idle rank: fewer episodes than ranks
            dev = tr.device
            parts.append((torch.zeros(0, device=dev), torch.zeros(0, dtype=torch.int32, device=dev),
                          torch.zeros((0, tr.env.bc_dim), device=dev)))
    return tuple(pod.gather_ragged([x[i] for x in parts], counts) for i in range(3))
