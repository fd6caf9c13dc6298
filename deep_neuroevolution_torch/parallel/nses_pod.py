"""Pod NS-ES and NSR-ES: an iteration's antithetic rounds split over the
ranks, novelty scored where the rollouts ran.

The counterpart of the JAX package's parallel/nses_pod.py
(``make_pod_nses_step``, :55-165). The current parent's θ and the novelty
archive are replicated; rank p evaluates its blocks of pairs and scores
their BCs against the archive (ops/novelty.py, the single trainer's
``_perturbed_eval``); the returns and novelty columns are gathered for the
global rank transform (NS: novelty ranks; NSR: their mean with the reward
ranks, nses.py:217-228). On a device env each rank then sums wᵢ·εᵢ over its
own rows with K2 and the partial sums are added across ranks
(parallel/trainers.py); on the host engine every rank computes the whole
update from the global columns (parallel/host_pod.py).

A block is ``npairs`` pairs of a rank's ⌈pairs / size⌉ (``eval_batch``
and ``theta_hbm_budget`` bound it, and on the host engine the slots); a
device pod runs as many rounds as that share needs (nses_pod.py's
``n_rounds``), a host pod one (host_pod.py:256-265).
"""

from __future__ import annotations

import torch

from .es_pod import block_rows, gather_column, local_sum, run_blocks


def blocks(tr):
    """(pairs a block, global rounds) of an iteration (the JAX package's
    PodNSESTrainer.train_step, trainers.py:378-383)."""
    cfg = tr.config
    cap = max(1, int(cfg.theta_hbm_budget) // (2 * tr.model.num_params * 4))
    per_rank = -(-max((cfg.population_size or 128) // 2, 1) // tr.pod.size)
    npairs = min(cfg.eval_batch or per_rank, cap, per_rank)
    if tr.is_host_env:
        return min(npairs, tr.env.batch_size // 2), 1
    return npairs, -(-per_rank // npairs)


def perturbed_eval(tr, single_eval):
    """The iteration's rounds through ``single_eval(npairs, draws)`` (the
    single trainer's ``_perturbed_eval``) on each rank's blocks. Returns the
    single trainer's tuple over the global rows in draw order (idxs,
    returns, novelty, lengths, bcs, ob_sum, ob_sumsq, ob_count); sets
    ``tr._rows``, each rank's global rows. Trajectory BCs are the blocks'
    2·npairs trajectories (θ+σε members first) one block after another."""
    npairs, n_rounds = blocks(tr)
    draws, out = run_blocks(tr, n_rounds, lambda: tr._draw_round(npairs), lambda d: single_eval(npairs, d))
    rets, nov, lens = (gather_column(tr, out, i, n_rounds) for i in (1, 2, 3))
    if tr.traj_bc:
        per_rank = tr.pod.gather_objects([[t for res in out[p] for t in res[4]] for p in tr.pod.pids])
        per_block = [trajs[r * 2 * npairs:(r + 1) * 2 * npairs] for r in range(n_rounds) for trajs in per_rank]
        bcs = tuple(t for blk in per_block for t in blk)
    else:
        bcs = gather_column(tr, out, 4, n_rounds)
    rows = block_rows(tr.pod.size, len(draws), npairs)
    tr._rows = [torch.as_tensor(rows[p], device=tr.device) for p in tr.pod.pids]
    ob = [local_sum(tr, out, i) for i in (5, 6, 7)]
    idxs = torch.cat([d[0] for d in draws])
    return (idxs, rets, nov, lens, bcs, ob[0], ob[1], 0.0 if ob[2] is None else ob[2])
