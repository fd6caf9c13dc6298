"""Evolution Strategies on the host engine, fixed-population mode.

The counterpart of the JAX package's algos/es.py ``ESTrainer`` host-engine
arm (``_host_round``, ``train_step``, ``_finalize_generation``), after
es_distributed/es.py and gpu_implementation/es.py:

* antithetic pairs θ ± σε, with ε a noise-table row at a sampled offset
  (es.py:411-426);
* a generation of ``population_size`` episodes, run in rounds of at most
  ``batch_size / 2`` pairs, further capped so the ``[2·pairs, D]`` θ batch
  stays under ``theta_hbm_budget`` bytes of device memory;
* VBN reference stats per perturbed member, from a reference batch that a
  random policy collects once (es.py:159-162);
* centered ranks, g = Σ(w⁺−w⁻)ᵢ·εᵢ / (2n) through kernel K2, and the
  optimizer step on −g + l2coeff·θ (es.py:281-301);
* the episode-cutoff DSL and its adaptive bump (es.py:169-186, 308-311);
* ``num_eval_episodes`` noiseless episodes of the pre-update θ each
  generation, on the first engine slots (es.py:588-611), logged as the
  reference's ``Eval*`` metrics;
* the reference's tabular metric names (es.py:314-343).

Host-side draws (θ init, noise offsets, rollout seeds) come from one CPU
``torch.Generator`` seeded with ``seed``; ``_draw_round`` is the single
place a round's randomness is drawn, ``_draw_eval_seed`` the eval
episodes'.

Not ported yet: quota mode (episodes/timesteps per batch), obs-stat
merging, mirrored pairs (``mirror_crn``), VINE dumps, device envs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models.core import Model
from ..ops import fitness, optim
from ..ops.noise import NoiseTable
from ..ops.noise_gradient import noise_gradient
from ..utils import tabular as tlogger
from .rollout_host import collect_ref_batch_host, rollout_host_batch


@dataclasses.dataclass
class ESConfig:
    """The reference Config fields this mode uses, plus engine knobs."""

    l2coeff: float = 0.005
    noise_stdev: float = 0.02
    population_size: int = 0  # episodes per generation (gpu es.py:197)
    return_proc_mode: str = "centered_rank"
    episode_cutoff_mode: Any = "env_default"
    num_eval_episodes: int = 8  # noiseless episodes of θ per generation
    theta_hbm_budget: int = 2**31  # bytes allowed for one round's [2·pairs, D] θ batch


class CutoffState(NamedTuple):
    """Adaptive episode-length curriculum (es.py:169-186)."""

    tslimit: int
    incr_threshold: float
    incr_ratio: float
    tslimit_max: int
    adaptive: bool


def parse_cutoff(mode: Any, env_default: int) -> CutoffState:
    """int | 'adaptive:start,thresh,ratio,max' | 'env_default'."""
    if isinstance(mode, int):
        return CutoffState(mode, 0.0, 1.0, mode, False)
    if isinstance(mode, str) and mode.startswith("adaptive:"):
        args = mode.split(":")[1].split(",")
        return CutoffState(int(args[0]), float(args[1]), float(args[2]), int(float(args[3])), True)
    if mode == "env_default":
        return CutoffState(env_default, 0.0, 1.0, env_default, False)
    raise NotImplementedError(f"episode_cutoff_mode {mode!r}")


def update_cutoff(c: CutoffState, lengths: np.ndarray) -> CutoffState:
    """es.py:308-311: raise the limit when at least the threshold share of
    rollouts hit it."""
    if c.adaptive and (lengths == c.tslimit).mean() >= c.incr_threshold:
        new = min(int(c.incr_ratio * c.tslimit), c.tslimit_max)
        tlogger.log(f"Increased timestep limit from {c.tslimit} to {new}")
        return c._replace(tslimit=new)
    return c


class GenStats(NamedTuple):
    returns: np.ndarray  # [n, 2] (pos, neg)
    lengths: np.ndarray  # [n, 2]
    grad_norm: float
    update_ratio: float
    seconds: float  # the generation's wall time (TimeElapsedThisIter)
    eval_returns: np.ndarray  # [num_eval_episodes] returns of the noiseless θ
    eval_lengths: np.ndarray  # [num_eval_episodes]


class ESTrainer:
    """Fixed-population ES on a host-engine env."""

    def __init__(
        self,
        env,
        model: Model,
        config: ESConfig,
        optimizer=None,
        noise_table: Optional[NoiseTable] = None,
        seed: int = 0,
        device=None,
    ):
        if not getattr(env, "is_host_env", False):
            raise NotImplementedError("only host-engine envs are ported yet")
        if config.population_size <= 0:
            raise NotImplementedError("only fixed-population mode (population_size > 0) is ported yet")
        self.device = resolve_device(device)
        self.env = env
        self.model = model
        self.config = config
        self.optimizer = optimizer or optim.Adam(stepsize=0.01)
        self.gen = torch.Generator().manual_seed(seed)
        self.noise = noise_table or NoiseTable.from_seed(device=self.device)
        if self.noise.noise.device != self.device:
            self.noise = NoiseTable(self.noise.noise.to(self.device))
        if self.noise.size <= model.num_params:
            raise ValueError(f"noise table ({self.noise.size}) must exceed num_params ({model.num_params})")
        self.theta = model.init_theta(self.gen, self.device)
        self.cutoff = parse_cutoff(config.episode_cutoff_mode, env.default_timestep_cutoff)
        self.ref_batch = None
        if model.needs_ref_batch:
            self.ref_batch = collect_ref_batch_host(env, self._draw_seed(), self.device)
        self.opt_state = self.optimizer.init(model.num_params, self.device)
        self.iteration = 0
        self.episodes_so_far = 0
        self.timesteps_so_far = 0
        self.last_stats: Optional[GenStats] = None
        self._tstart = time.time()

    # --------------------------------------------------------------- draws

    def _draw_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.gen))

    def _draw_round(self, npairs: int) -> Tuple[torch.Tensor, int]:
        """A round's randomness: ``npairs`` noise offsets (int32, CPU) and
        the rollout seed."""
        idxs = self.noise.sample_index_batch(self.gen, self.model.num_params, npairs)
        return idxs, self._draw_seed()

    def _draw_eval_seed(self) -> int:
        """The rollout seed of a generation's eval episodes."""
        return self._draw_seed()

    # -------------------------------------------------------------- rounds

    def _npairs_round(self) -> int:
        cfg = self.config
        cap = max(1, int(cfg.theta_hbm_budget) // (2 * self.model.num_params * 4))
        return max(min(cfg.population_size // 2, cap, self.env.batch_size // 2), 1)

    def _host_round(self, npairs: int):
        """One antithetic round: θ±σε for ``npairs`` pairs on the first
        ``2·npairs`` engine slots. Returns (idxs, returns [n,2],
        sign returns [n,2], lengths [n,2])."""
        idxs, seed = self._draw_round(npairs)
        idxs = idxs.to(self.device)
        eps = self.noise.get_batch(idxs, self.model.num_params)
        sigma = self.config.noise_stdev
        thetas = torch.cat([self.theta[None] + sigma * eps, self.theta[None] - sigma * eps])
        del eps
        with record_function("es.ref_stats"):
            stats = self.model.batch_ref_stats(thetas, self.ref_batch) if self.model.needs_ref_batch else None
        if 2 * npairs < self.env.batch_size:  # unused slots run copies of the last member
            pad = self.env.batch_size - 2 * npairs
            thetas = torch.cat([thetas, thetas[-1:].expand(pad, -1)])
            if stats is not None:
                stats = type(stats)(*(tuple(torch.cat([x, x[-1:].expand(pad, -1)]) for x in f) for f in stats))
        with record_function("es.rollout"):
            res = rollout_host_batch(
                self.env, self.model.make_batch_act(), (thetas, stats), seed, int(self.cutoff.tslimit), self.device
            )
        pair = lambda x: np.stack([x[:npairs], x[npairs : 2 * npairs]], axis=1)  # noqa: E731
        return idxs, pair(res.returns), pair(res.sign_returns), pair(res.lengths)

    def _host_eval(self, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        """Noiseless episodes of θ on the first ``n = min(num_eval_episodes,
        slots)`` engine slots, every slot with θ and one member's reference
        stats (es.py:588-611). Returns (returns [n], lengths [n])."""
        n = min(self.config.num_eval_episodes, self.env.batch_size)
        thetas = self.theta[None].expand(n, -1)
        stats = None
        if self.model.needs_ref_batch:
            one = self.model.batch_ref_stats(self.theta[None], self.ref_batch)
            stats = type(one)(*(tuple(x.expand(n, -1) for x in f) for f in one))
        res = rollout_host_batch(
            self.env, self.model.make_batch_act(), (thetas, stats), seed, int(self.cutoff.tslimit), self.device,
            n_slots=n,
        )
        return res.returns[:n], res.lengths[:n]

    # ---------------------------------------------------------- generation

    def _compute_update(self, noise_idxs: torch.Tensor, returns_n2: np.ndarray, signreturns_n2: np.ndarray):
        """Rank transform → gradient (K2) → L2 → optimizer step. Returns
        (g, new opt state, new θ, update ratio)."""
        cfg = self.config
        rets = torch.as_tensor(returns_n2, device=self.device)
        srets = torch.as_tensor(signreturns_n2, device=self.device)
        proc = fitness.process_returns(rets, srets, cfg.return_proc_mode)
        w = (proc[:, 0] - proc[:, 1]).contiguous()
        g = noise_gradient(self.noise.noise, noise_idxs.to(self.device, torch.int32).contiguous(), w, self.model.num_params)
        g = g / returns_n2.size  # es.py:296
        opt_state, theta, ratio = self.optimizer.update(self.opt_state, self.theta, -g + cfg.l2coeff * self.theta)
        return g, opt_state, theta, ratio

    def train_step(self) -> GenStats:
        cfg = self.config
        step_tstart = time.time()
        eval_seed = self._draw_eval_seed() if cfg.num_eval_episodes > 0 else None
        npairs = self._npairs_round()
        all_idxs, all_rets, all_srets, all_lens = [], [], [], []
        episodes = 0
        while episodes < cfg.population_size:
            idxs, rets, srets, lens = self._host_round(npairs)
            all_idxs.append(idxs)
            all_rets.append(rets)
            all_srets.append(srets)
            all_lens.append(lens)
            episodes += lens.size
        noise_idxs = torch.cat(all_idxs)
        returns_n2 = np.concatenate(all_rets)
        lengths_n2 = np.concatenate(all_lens)
        with record_function("es.update"):
            g, opt_state, theta, ratio = self._compute_update(noise_idxs, returns_n2, np.concatenate(all_srets))
        gnorm = float(torch.sum(g * g))
        eval_rets, eval_lens = np.zeros(0, np.float32), np.zeros(0, np.int32)
        if eval_seed is not None:
            with record_function("es.eval"):
                eval_rets, eval_lens = self._host_eval(eval_seed)  # θ before the update
        return self._finalize_generation(
            opt_state, theta, float(ratio), gnorm, returns_n2, lengths_n2, eval_rets, eval_lens, step_tstart
        )

    def _finalize_generation(
        self, opt_state, theta, ratio, gnorm, returns_n2, lengths_n2, eval_rets, eval_lens, step_tstart
    ) -> GenStats:
        """State swap, cutoff curriculum, and the reference-named metrics."""
        self.cutoff = update_cutoff(self.cutoff, lengths_n2)
        self.opt_state, self.theta = opt_state, theta
        self.iteration += 1
        self.episodes_so_far += int(lengths_n2.size)
        self.timesteps_so_far += int(lengths_n2.sum())
        step_tend = time.time()
        tlogger.record_tabular("EpRewMean", returns_n2.mean())
        tlogger.record_tabular("EpRewStd", returns_n2.std())
        tlogger.record_tabular("EpLenMean", lengths_n2.mean())
        tlogger.record_tabular("TimestepLimitPerEpisode", int(self.cutoff.tslimit))
        none = eval_rets.size == 0
        tlogger.record_tabular("EvalEpRewMean", np.nan if none else eval_rets.mean())
        tlogger.record_tabular("EvalEpRewMedian", np.nan if none else np.median(eval_rets))
        tlogger.record_tabular("EvalEpRewStd", np.nan if none else eval_rets.std())
        tlogger.record_tabular("EvalEpLenMean", np.nan if none else eval_lens.mean())
        tlogger.record_tabular(
            "EvalPopRank",
            np.nan if none else np.searchsorted(np.sort(returns_n2.ravel()), eval_rets).mean() / returns_n2.size,
        )
        tlogger.record_tabular("EvalEpCount", int(eval_rets.size))
        tlogger.record_tabular("Norm", float(torch.sum(theta * theta)))
        tlogger.record_tabular("GradNorm", gnorm)
        tlogger.record_tabular("UpdateRatio", ratio)
        tlogger.record_tabular("EpisodesThisIter", int(lengths_n2.size))
        tlogger.record_tabular("EpisodesSoFar", self.episodes_so_far)
        tlogger.record_tabular("TimestepsThisIter", int(lengths_n2.sum()))
        tlogger.record_tabular("TimestepsSoFar", self.timesteps_so_far)
        tlogger.record_tabular("UniqueWorkers", 1)
        tlogger.record_tabular("UniqueWorkersFrac", 1.0)
        tlogger.record_tabular("ResultsSkippedFrac", 0.0)
        tlogger.record_tabular("ObCount", 0.0)
        tlogger.record_tabular("TimeElapsedThisIter", step_tend - step_tstart)
        tlogger.record_tabular("TimeElapsed", step_tend - self._tstart)
        tlogger.record_tabular(
            "TimestepsPerSecondThisIter", int(lengths_n2.sum()) / max(step_tend - step_tstart, 1e-9)
        )
        tlogger.dump_tabular()
        self.last_stats = GenStats(
            returns_n2, lengths_n2, gnorm, ratio, step_tend - step_tstart, eval_rets, eval_lens
        )
        return self.last_stats

    def train(self, iterations: int):
        for _ in range(iterations):
            self.train_step()

    def close(self) -> None:
        """Stop the env's engine threads."""
        self.env.close()
