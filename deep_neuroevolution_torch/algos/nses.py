"""NS-ES and NSR-ES: novelty-seeking ES over a meta-population of parents.

The counterpart of the JAX package's algos/nses.py, after
es_distributed/nses.py:

* M parents, each with its own θ, optimizer state and obs stats
  (nses.py:95-117);
* an archive seeded with each parent's mean BC over ``num_rollouts``
  noiseless episodes (nses.py:34-39, 113-114), and grown by the updated
  parent's mean BC every iteration (nses.py:246-247);
* each iteration perturbs the current parent antithetically; each
  rollout's BC is scored by its k-NN novelty against the archive, which
  takes the sign returns' place (nses.py:381-387), so that
  ``centered_sign_rank`` ranks novelty; ``algo_type='nsr'`` averages the
  reward ranks in (nses.py:226-228); g/(2n) and Adam on −g + l2·θ, as ES;
* the next parent by ``novelty_prob`` (every parent's mean BC rolled
  again, its novelty normalized into probabilities, nses.py:293-306) or
  ``round_robin``.

The trainer is ESTrainer's with the current parent's state loaded into it:
a round is ES's device round (pairs from one reset state) or host round
(the Atari engine or a vector engine such as MuJoCo's; the reference
stats for the real members only, spare slots running copies of the last
and left out of the obs sums), and the update is ES's, with the novelty
ranks. The round's obs sums merge into the current parent's stats.

BCs: ``bc_mode='final'`` keeps the final-state BC (the maze's x-y, the
Atari engine's final RAM, the MuJoCo engine's final mass centre or its
padded x-y trajectory, the env's ``bc_mode``) in a device ``Archive``
(ops/novelty.py); ``bc_mode='traj'`` is the Atari per-step RAM trajectory
(ESAtariPolicy.rollout, policies.py:410-418), the Atari engine only (the
JAX package's nses.py:205-208), kept in a host list and scored with the
length-tolerant float64 k-NN.

On a device env whose model keeps no obs stats, every parent's mean BC
comes from one rollout of M·num_rollouts slots (the JAX package's
``_mean_bc_parents``); otherwise, and on the host engine, one rollout a
parent.

Randomness comes from the trainer's CPU ``torch.Generator`` (ES's
``_draw_round``), and the parent draw of ``novelty_prob`` from a NumPy
generator seeded from it; JAX's threefry draws cannot be reproduced.

The noise source is a table or a ``VirtualNoise``, through ES's
perturbation and gradient (the JAX package's ``_table_arg``, nses.py:88-95,
248-251). The pod trainers are in parallel/.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from ..models.mlp import MLPContext
from ..ops import fitness, novelty, obstat
from ..utils import tabular as tlogger
from ..utils.trace import span
from .es import ESConfig, ESTrainer, pair_columns, update_cutoff
from .rollout import rollout_batch
from .rollout_host import rollout_host


@dataclasses.dataclass
class NSESConfig(ESConfig):
    algo_type: str = "ns"  # 'ns' | 'nsr' (nses.py:63)
    k: int = 10  # k-NN size (novelty_search.k)
    meta_population_size: int = 3  # novelty_search.population_size
    num_rollouts: int = 1  # episodes a mean BC averages (novelty_search.num_rollouts)
    selection_method: str = "novelty_prob"  # | 'round_robin'
    archive_capacity: int = 10_000  # initial; the archive doubles when full
    return_proc_mode: str = "centered_sign_rank"
    bc_mode: str = "final"  # | 'traj' (host engine: the per-step RAM trajectory)
    num_eval_episodes: int = 0  # NS-ES runs no eval episodes


class Parent(NamedTuple):
    theta: torch.Tensor
    opt_state: Any
    ob_stat: obstat.RunningStat


class NSStats(NamedTuple):
    parent: int  # the parent this iteration updated
    returns: np.ndarray  # [n, 2]
    lengths: np.ndarray  # [n, 2]
    novelty: np.ndarray  # [n, 2] f32, each rollout's k-NN novelty
    bc: Any  # [n, 2, bc_dim] (final) or the 2n trajectories, θ+σε members first (traj)
    g: torch.Tensor  # [D] the gradient, g/(2n)
    new_bc: np.ndarray  # the archive's new point
    selection_probs: Optional[np.ndarray]  # [M] novelty_prob's probabilities
    grad_norm: float
    update_ratio: float
    seconds: float


class NSESTrainer(ESTrainer):
    def __init__(self, env, model, config: NSESConfig, optimizer=None, noise_table=None, seed: int = 0,
                 device=None):
        if not env.bc_dim:
            raise ValueError("NS-ES needs an env with a behavior characterization")
        if config.algo_type not in ("ns", "nsr"):
            raise ValueError(f"algo_type must be 'ns' or 'nsr', not {config.algo_type!r}")
        if config.selection_method not in ("novelty_prob", "round_robin"):
            raise NotImplementedError(f"selection_method {config.selection_method!r}")
        if config.bc_mode not in ("final", "traj"):
            raise ValueError(f"bc_mode must be 'final' or 'traj', not {config.bc_mode!r}")
        if config.bc_mode == "traj" and not (getattr(env, "is_host_env", False)
                                             and getattr(env, "host_obs", "image") == "image"):
            raise ValueError("bc_mode='traj' is the Atari RAM-per-step BC: Atari host engines only, "
                             "not a device env or a vector engine (MuJoCo)")
        if config.algo_type == "ns" and config.return_proc_mode == "centered_rank":
            # novelty rides the sign returns (nses.py:381-387), and
            # 'centered_rank' ranks the reward: pure NS with it is ES
            tlogger.log("warning: NS-ES with algo_type='ns' and return_proc_mode='centered_rank' optimizes "
                        "reward, not novelty; the NS configurations use 'centered_sign_rank'")
        super().__init__(env, model, config, optimizer, noise_table, seed, device)
        self.traj_bc = config.bc_mode == "traj"
        self.archive = novelty.archive_init(config.archive_capacity, env.bc_dim, self.device)
        self.host_archive: List[np.ndarray] = []  # the trajectories, for bc_mode='traj'
        # parent 0 is the θ, optimizer state and obs stats ESTrainer made
        self.parents: List[Parent] = []
        for p in range(config.meta_population_size):
            theta = self.theta if p == 0 else model.init_theta(self.gen, self.device)
            self.parents.append(Parent(theta, self.optimizer.init(model.num_params, self.device),
                                       obstat.init(env.obs_shape, eps=1e-2, device=self.device)))
            self._archive_add(self._mean_bc(p))
        self.curr_parent = 0
        self.last_stats: Optional[NSStats] = None

    # ------------------------------------------------- archive abstraction

    def _archive_add(self, bc) -> None:
        if self.traj_bc:
            self.host_archive.append(np.asarray(bc))
        else:
            self.archive = novelty.archive_add(self.archive, torch.as_tensor(bc))

    def _archive_size(self) -> int:
        return len(self.host_archive) if self.traj_bc else int(self.archive.count)

    def _archive_novelty(self, bcs) -> np.ndarray:
        """Each BC's k-NN novelty against the archive, float32 numpy: the
        length-tolerant float64 metric for trajectories, the device's
        distance matrix otherwise."""
        if self.traj_bc:
            return np.array([novelty.compute_novelty_vs_archive(self.host_archive, b, self.config.k) for b in bcs],
                            np.float32)
        if isinstance(bcs, (list, tuple)):
            bcs = torch.stack([torch.as_tensor(b) for b in bcs])
        return novelty.novelty_vs_archive(self.archive, bcs, self.config.k).cpu().numpy()

    # ------------------------------------------------------------ mean BCs

    def _mean_bc(self, p: int):
        """Parent ``p``'s mean BC over ``num_rollouts`` noiseless episodes
        (nses.py:34-39): a ``[bc_dim]`` tensor, or for 'traj' the
        common-prefix mean of the trajectories (the reference's np.mean
        needs equal lengths; the prefix mean is its extension to ragged
        ones)."""
        par = self.parents[p]
        if not self.is_host_env:
            return self._device_mean_bcs(par.theta[None], par.ob_stat)[0]
        n = min(self.config.num_rollouts, self.env.batch_size)
        seed = self._draw_seed()
        params = self._host_params(par.theta[None].expand(n, -1), False, seed, par.ob_stat)
        res = rollout_host(self.env, self.model.make_batch_act(), params, seed, int(self.cutoff.tslimit_max),
                           self.device, n_slots=n, collect_bc_traj=self.traj_bc)
        if self.traj_bc:
            trs = res.bc_traj[:n]
            L = min(t.shape[0] for t in trs)
            return np.mean([t[:L] for t in trs], axis=0)
        return torch.from_numpy(res.bc[:n]).mean(dim=0).to(self.device)

    def _device_mean_bcs(self, thetas_m: torch.Tensor, ob_stat) -> torch.Tensor:
        """``[M, bc_dim]``: the mean BC of each of the M rows of ``thetas_m``,
        from one rollout of M·num_rollouts slots, each from its own reset
        state (the JAX package's ``_mean_bc_parents``; with M = 1, its
        ``_mean_bc``)."""
        R = self.config.num_rollouts
        thetas = thetas_m.repeat_interleave(R, dim=0)
        state, gen = self._episode_starts(self._draw_seed(), thetas.shape[0], paired=False)
        ctx = None
        if self.model.needs_ob_stat:
            ctx = MLPContext(obstat.mean(ob_stat), obstat.std(ob_stat), 0.0, gen, False)
        res = rollout_batch(self.env, self.model.make_batch_act(), self._device_params(thetas, ctx), state,
                            int(self.cutoff.tslimit_max))
        return res.bc.reshape(thetas_m.shape[0], R, -1).mean(dim=1)

    # ------------------------------------------------------------ iteration

    def _load(self, p: int) -> None:
        """ESTrainer's state is parent ``p``'s."""
        self.theta, self.opt_state, self.ob_stat = self.parents[p]

    def _process_returns(self, rets: torch.Tensor, novelty_n2: torch.Tensor) -> torch.Tensor:
        """Novelty ranks in the sign returns' slot; NSR averages the reward
        ranks in (nses.py:226-228)."""
        proc = super()._process_returns(rets, novelty_n2)
        if self.config.algo_type == "nsr":
            proc = (fitness.compute_centered_ranks(rets) + proc) / 2.0
        return proc

    def _perturbed_eval(self, npairs: int, draws=None):
        """One antithetic round of the current parent with each rollout's BC
        and novelty; ``draws`` is the round's ``_draw_round`` when the caller
        made it. Returns (idxs, returns, novelty, lengths, bc, ob_sum,
        ob_sumsq, ob_count): columns [n, 2], on the device but idxs on the
        device env; numpy on the host engine."""
        cfg = self.config
        if not self.is_host_env:
            p = cfg.calc_obstat_prob
            obstat_prob = p if self.model.needs_ob_stat and 0.0 < p < 1.0 else None
            idxs, rets, _, lens, bcs, ob_sum, ob_sumsq, ob_count, _ = self._device_round(npairs, obstat_prob, draws)
            if not (self.model.needs_ob_stat and cfg.calc_obstat_prob > 0):
                ob_count = 0.0  # nothing is collected (the JAX package's collect_obstat)
            with span("nses.novelty"):
                nov = novelty.novelty_vs_archive(self.archive, bcs.reshape(2 * npairs, -1), cfg.k)
            return idxs, rets, nov.reshape(npairs, 2), lens, bcs, ob_sum, ob_sumsq, ob_count
        idxs, res = self._host_rollout(npairs, collect_bc_traj=self.traj_bc, draws=draws)
        with span("nses.novelty"):
            if self.traj_bc:
                bcs = res.bc_traj[: 2 * npairs]
                nov = self._archive_novelty(bcs)
            else:
                bcs = pair_columns(res.bc, npairs)
                nov = self._archive_novelty(torch.from_numpy(res.bc[: 2 * npairs]))
        return (idxs, pair_columns(res.returns, npairs), pair_columns(nov, npairs), pair_columns(res.lengths, npairs),
                bcs, *self._ob_sums(res))

    def train_step(self) -> NSStats:
        """One iteration: the current parent's round and update, the
        obs-stat merge, the archive insert, the next parent and the
        reference's tabular row (nses.py:185-306)."""
        cfg = self.config
        p = self.curr_parent
        self._load(p)
        step_tstart = time.time()
        npairs = self._npairs_round()
        with span("nses.rollout"):
            idxs, rets, nov, lens, bcs, ob_sum, ob_sumsq, ob_count = self._perturbed_eval(npairs)
        with span("es.update"):
            g, opt_state, theta, ratio = self._compute_update(idxs, rets, nov)
        gnorm = float(torch.sum(g * g))
        returns_n2, novelty_n2, lengths_n2, ratio, ob_count = (
            x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (rets, nov, lens, ratio, ob_count))
        ratio, ob_count = float(ratio), float(ob_count)
        if torch.is_tensor(bcs):
            bcs = bcs.cpu().numpy()

        ob_stat = self.parents[p].ob_stat
        if self.model.needs_ob_stat and cfg.calc_obstat_prob > 0 and ob_count > 0:  # nses.py:197-198, 291
            ob_stat = obstat.increment(ob_stat, ob_sum, ob_sumsq, ob_count)
        self.parents[p] = Parent(theta, opt_state, ob_stat)
        self._load(p)

        # the updated parent's mean BC joins the archive (nses.py:246-247);
        # on a device env without obs stats, every parent's mean BC comes
        # from one rollout and serves the selection below too
        bcs_m = None
        with span("nses.mean_bc"):
            if not self.is_host_env and not self.model.needs_ob_stat:
                bcs_m = self._device_mean_bcs(torch.stack([par.theta for par in self.parents]), None)
                new_bc = bcs_m[p]
            else:
                new_bc = self._mean_bc(p)
        self._archive_add(new_bc)

        self.cutoff = update_cutoff(self.cutoff, lengths_n2)
        self.iteration += 1
        self.episodes_so_far += int(lengths_n2.size)
        self.timesteps_so_far += int(lengths_n2.sum())

        probs = None
        if cfg.selection_method == "novelty_prob":  # nses.py:293-306
            with span("nses.mean_bc"):
                bcs_sel = bcs_m if bcs_m is not None else [self._mean_bc(q) for q in range(len(self.parents))]
            with span("nses.novelty"):
                novs = self._archive_novelty(bcs_sel)
            probs = novs / novs.sum()
            self.curr_parent = int(np.random.default_rng(self._draw_seed()).choice(len(self.parents), p=probs))
        else:
            self.curr_parent = (p + 1) % len(self.parents)

        step_tend = time.time()
        new_bc = new_bc.cpu().numpy() if torch.is_tensor(new_bc) else np.asarray(new_bc)
        tlogger.record_tabular("ParentId", p)
        tlogger.record_tabular("EpRewMean", returns_n2.mean())
        tlogger.record_tabular("EpRewStd", returns_n2.std())
        tlogger.record_tabular("EpLenMean", lengths_n2.mean())
        tlogger.record_tabular("EpNovMean", float(novelty_n2.mean()))
        tlogger.record_tabular("Norm", float(torch.sum(theta * theta)))
        tlogger.record_tabular("GradNorm", gnorm)
        tlogger.record_tabular("UpdateRatio", ratio)
        tlogger.record_tabular("EpisodesThisIter", int(lengths_n2.size))
        tlogger.record_tabular("EpisodesSoFar", self.episodes_so_far)
        tlogger.record_tabular("TimestepsThisIter", int(lengths_n2.sum()))
        tlogger.record_tabular("TimestepsSoFar", self.timesteps_so_far)
        tlogger.record_tabular("ObCount", ob_count)  # nses.py:281
        tlogger.record_tabular("ArchiveSize", self._archive_size())
        tlogger.record_tabular("TimeElapsedThisIter", step_tend - step_tstart)
        tlogger.record_tabular("TimeElapsed", step_tend - self._tstart)
        tlogger.dump_tabular()
        self.last_stats = NSStats(p, returns_n2, lengths_n2, novelty_n2, bcs, g, new_bc, probs, gnorm, ratio,
                                  step_tend - step_tstart)
        return self.last_stats
