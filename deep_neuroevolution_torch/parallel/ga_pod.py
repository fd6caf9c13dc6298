"""Pod GA and RS: a generation's offspring split over the ranks.

The counterpart of the JAX package's parallel/ga_pod.py
(``make_pod_ga_step``, :34-117). Every rank holds the cached parents' θ
rows and makes every block's draws (parent and noise indices, then the
rollout seed, the single trainer's order); rank p builds its block's
offspring (``GATrainer._offspring_thetas``, ops/genome.py) and evaluates
them, and the returns, lengths and BCs come back in the blocks' draw order
(ga_pod.py:26-32). Truncation selection and the ladder stay in
``GATrainer``.

A block holds ``_chunk(⌈n / size⌉)`` members: the single trainer's cap
(the engine's slots or ``eval_batch``, and ``theta_hbm_budget``) on a
rank's share of the population. The host pods take the same rule, so a
round's θ stays under ``theta_hbm_budget`` there too (the JAX package's
host_pod.py:177-196 sizes a round by the slots alone).
"""

from __future__ import annotations

import numpy as np

from .es_pod import gather_column, run_blocks


def fitness_pass(tr, n: int, power: float, randomize: bool):
    """``n`` offspring made and evaluated, one episode each, split over the
    ranks; a last block's surplus members are dropped, as the single
    trainer drops its last round's. Returns numpy (pidx, midx, rewards,
    lengths, bcs), ``[n]`` each, equal on every rank."""
    per_rank = -(-n // tr.pod.size)
    chunk = tr._chunk(per_rank)
    n_rounds = -(-per_rank // chunk)
    n_parents = 0 if randomize else len(tr.cached_parent_seeds)

    def draw():
        pidx, midx = tr._draw_offspring(chunk, n_parents)
        return pidx, midx, tr._draw_seed()

    def run(d):
        thetas = tr._offspring_thetas(d[0], d[1], power, randomize)
        return tr._eval(thetas, tr.cutoff.tslimit, d[2])

    draws, out = run_blocks(tr, n_rounds, draw, run)
    cols = [gather_column(tr, out, i, n_rounds) for i in range(3)]
    cols = [c if isinstance(c, np.ndarray) else c.cpu().numpy() for c in cols]
    pidx, midx = (np.concatenate([d[i] for d in draws]) for i in (0, 1))
    return tuple(x[:n] for x in (pidx, midx, *cols))
