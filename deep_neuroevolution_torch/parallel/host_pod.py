"""Host-engine pods: an engine pool on every rank, one replicated update.

The counterpart of the JAX package's parallel/host_pod.py. The reference
scales by simulator fleets feeding one optimization (es_distributed/
main.py:74-86 forks a relay and N workers a machine; the GPU stack runs one
fleet a GPU, concurrent_worker.py:129-142). Here every rank owns its own
``HostBatchEnv`` engine pool (native/bridge.py) and its card, evaluates
its blocks of each global round, and the per-episode columns are gathered
in rank order (``_hp_gather_cols``, host_pod.py:59-70); the obs-stat
moments are summed (``_hp_sum``, :72-81; ``PopGroup.sum``, the padded
slots of a rank's under-filled block left out by the rollout's
``obstat_valid``). Every rank then computes the
whole update from the global columns, so ES runs K2 over all of a
generation's offsets on every rank, and a host pod's θ equals the single
trainer's bit for bit wherever the episodes do.

Rank 0 alone runs the engine work that is not a block of a round, and
sends its results to the others: the VBN reference batch, ES's eval
episodes (the JAX package keeps the first process's, :118-127) and NS-ES's
mean-BC episodes. Each rank's engine then plays only its own blocks, which
keeps the engines' histories the same in a real world and in its
emulation: an EpisodicLife reset goes on with the game a life loss
interrupted, so an engine's past changes its next episodes.

``emulate_procs = P`` (the loader's ``host_pod: P``) runs the P ranks one
after the other in one process, rank p's blocks on its own engine pool
(``AtariEnv.spawn``, ``MujocoHostEnv.spawn``), as P processes run them (the JAX package's
emulation, :1-24, which shares one pool).

The GA's ladder splits its (candidate × episode) list as the JAX package's
``_eval_chunked`` does (:198-238): ⌈total / P⌉ contiguous entries a rank,
in rounds of the engine's slots, a rank with none idle. A fitness round
takes the single trainer's ``_chunk`` cap, ``theta_hbm_budget`` included
(parallel/ga_pod.py), which the JAX package's ``_fitness_pass`` leaves out
(:177-196).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..algos.es import ESTrainer
from ..algos.ga import GATrainer, RSTrainer
from ..algos.nses import NSESTrainer
from . import ga_pod, nses_pod
from .es_pod import gather_column, local_sum, run_blocks
from .trainers import _PodBase


def ladder_split(n_candidates: int, episodes_per: int, size: int, slots: int) -> List[List[np.ndarray]]:
    """The ladder's (candidate × episode) list split over ``size`` ranks (the
    JAX package's host_pod.py:198-238): rank p takes entries
    ``[p·⌈total/size⌉, (p+1)·⌈total/size⌉)``, in rounds of ``slots``. Returns,
    for each rank, each round's candidate indices (none for an idle rank)."""
    total = n_candidates * episodes_per
    idx_map = np.repeat(np.arange(n_candidates), episodes_per)
    per = -(-total // size)
    out = []
    for p in range(size):
        lo, hi = p * per, min((p + 1) * per, total)
        out.append([idx_map[s:min(s + slots, hi)] for s in range(lo, hi, slots)])
    return out


class _HostPod(_PodBase):
    """Per-rank engine pools, rank-0 engine work sent to every rank."""

    def _pre_init(self, env, device, emulate_procs: Optional[int]) -> None:
        if not getattr(env, "is_host_env", False):
            raise ValueError("host pods drive host-engine envs; a device env scales through the device pods "
                             "(parallel/trainers.py; the loader's 'pod' override)")
        self._init_pod(device, emulate_procs)
        self._engines = [env]

    def _post_init(self) -> None:
        """An emulated rank's own engine pool, fresh as a real rank's."""
        if self.pod.emulated:
            self._engines += [self.env.spawn() for _ in self.pod.pids[1:]]

    def _on_rank(self, p: int):
        return _Engine(self, self._engines[self.pod.pids.index(p)])

    def _on_rank0(self, fn, *args):
        """``fn(*args)`` on rank 0's engine, its result (numpy or plain
        Python) on every rank."""
        out = None
        if 0 in self.pod.pids:
            with self._on_rank(0):
                out = fn(*args)
        return self.pod.broadcast(out)

    def _collect_ref_batch(self, seed: int) -> torch.Tensor:
        ref = self._on_rank0(lambda s: super(_HostPod, self)._collect_ref_batch(s).cpu().numpy(), seed)
        return torch.from_numpy(ref).to(self.device)

    def close(self) -> None:
        super().close()
        for e in self._engines[1:]:
            e.close()


class _Engine:
    """Rank p's engine as the trainer's env for a block."""

    def __init__(self, tr, env):
        self.tr, self.env = tr, env

    def __enter__(self):
        self.saved, self.tr.env = self.tr.env, self.env

    def __exit__(self, *exc):
        self.tr.env = self.saved
        return False


class HostPodESTrainer(_HostPod, ESTrainer):
    """ES over per-rank engine pools: each global round is one single-trainer
    round a rank; the columns gathered, the update replicated (the
    es.py:230-265 master loop with the Redis tree replaced by a
    collective)."""

    def __init__(self, env, model, config, optimizer=None, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._pre_init(env, device, emulate_procs)
        super().__init__(env, model, config, optimizer=optimizer, noise_table=noise_table, seed=seed, device=device)
        self._post_init()

    def _host_round(self, npairs: int, draws=None):
        draws, out = run_blocks(self, 1, lambda: self._draw_round(npairs),
                                lambda d: ESTrainer._host_round(self, npairs, d))
        return (torch.cat([d[0] for d in draws]), *(gather_column(self, out, i, 1) for i in range(1, 6)),
                *(local_sum(self, out, i) for i in (6, 7, 8)))

    def _host_eval(self, seed: int):
        return self._on_rank0(lambda s: ESTrainer._host_eval(self, s), seed)


class HostPodGATrainer(_HostPod, GATrainer):
    """The GA over per-rank engine pools: the fitness pass split over the
    ranks (parallel/ga_pod.py), the ladder split as the JAX package splits
    it; selection, the elite and the parent cache computed alike on every
    rank from the gathered columns."""

    def __init__(self, env, model, config, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._pre_init(env, device, emulate_procs)
        super().__init__(env, model, config, noise_table=noise_table, seed=seed, device=device)
        self._post_init()

    def _fitness_pass(self, n: int, power: float, randomize: bool):
        return ga_pod.fitness_pass(self, n, power, randomize)

    def _eval_chunked(self, thetas: torch.Tensor, tslimit: int, episodes_per: int = 1):
        N = int(thetas.shape[0])
        split = ladder_split(N, episodes_per, self.pod.size, self.env.batch_size)
        parts = {p: [] for p in self.pod.pids}
        for p, rounds in enumerate(split):
            for cand in rounds:
                seed = self._draw_seed()  # every rank draws every round's seed
                if p in parts:
                    part = thetas.index_select(0, torch.as_tensor(cand, device=thetas.device))
                    with self._on_rank(p):
                        parts[p].append(self._eval_host(part, tslimit, seed))
        counts = [sum(len(c) for c in rounds) for rounds in split]
        bc_dim = self.env.bc_dim
        empty = (np.zeros(0, np.float32), np.zeros(0, np.int32), np.zeros((0, bc_dim), np.float32))
        cols = []
        for i in range(3):
            local = [np.concatenate([r[i] for r in parts[p]]) if parts[p] else empty[i] for p in self.pod.pids]
            cols.append(self.pod.gather_ragged(local, counts))
        rets, lens, bcs = cols
        return (rets.reshape(N, episodes_per), lens.reshape(N, episodes_per),
                bcs.reshape((N, episodes_per) + bcs.shape[1:]))


class HostPodRSTrainer(HostPodGATrainer, RSTrainer):
    """Random search over per-rank engine pools (RSTrainer's rules)."""


class HostPodNSESTrainer(_HostPod, NSESTrainer):
    """NS-ES and NSR-ES over per-rank engine pools: a rank's share of the
    pairs, scored against the replicated archive where it ran; the
    columns gathered, the update and the archive replicated; the mean-BC
    episodes on rank 0."""

    def __init__(self, env, model, config, optimizer=None, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._pre_init(env, device, emulate_procs)
        super().__init__(env, model, config, optimizer=optimizer, noise_table=noise_table, seed=seed, device=device)
        self._post_init()

    def _npairs_round(self) -> int:
        return nses_pod.blocks(self)[0]

    def _perturbed_eval(self, npairs: int, draws=None):
        return nses_pod.perturbed_eval(self, super()._perturbed_eval)

    def _mean_bc(self, p: int):
        if 0 not in self.pod.pids:
            self._draw_seed()  # rank 0's rollout draws its seed: every rank keeps the generator in step
        bc = self._on_rank0(lambda q: _host_value(NSESTrainer._mean_bc(self, q)), p)
        return bc if self.traj_bc else torch.from_numpy(bc).to(self.device)


def _host_value(x):
    return x.cpu().numpy() if torch.is_tensor(x) else x
