"""Evolution Strategies in fixed-population mode, on the host engine or a
device env.

The counterpart of the JAX package's algos/es.py ``ESTrainer``, after
es_distributed/es.py and gpu_implementation/es.py:

* antithetic pairs θ ± σε, with ε a noise-table row at a sampled offset
  (es.py:411-426);
* a generation of ``population_size`` episodes, run in rounds of pairs,
  capped so the ``[2·pairs, D]`` θ batch stays under ``theta_hbm_budget``
  bytes of device memory (and, on the host engine, by the slot count);
* VBN reference stats per perturbed member, from a reference batch that a
  random policy collects once (es.py:159-162);
* centered ranks, g = Σ(w⁺−w⁻)ᵢ·εᵢ / (2n) through kernel K2, and the
  optimizer step on −g + l2coeff·θ (es.py:281-301);
* the episode-cutoff DSL and its adaptive bump (es.py:169-186, 308-311);
* ``num_eval_episodes`` noiseless episodes of the pre-update θ each
  generation (es.py:388-405), logged as the reference's ``Eval*`` metrics;
* the reference's tabular metric names (es.py:314-343).

Two arms run a round. The host arm (``_host_round``, ``_host_eval``)
drives the C++ engine through algos/rollout_host.py. The device arm
(``_device_round``, ``_device_eval``; the JAX package's
``_perturbed_round_body``, ``_eval_theta_body`` and ``_fused_generation``'s
order) steps a device env in lockstep with the population forward
(algos/rollout.py): pairs start from one reset state and share their
action noise; every rollout's observations go into obs-stat sums, each
rollout with probability ``calc_obstat_prob`` when it lies in (0, 1); the
sums merge into the running stats when the model normalizes observations
and ``calc_obstat_prob`` > 0 (es.py:246-248, 356-363). A generation reads
the device's results on the host once, after its update and eval episodes.

Host-side draws (θ init, noise offsets, rollout seeds) come from one CPU
``torch.Generator`` seeded with ``seed``; ``_draw_round`` is the single
place a round's randomness is drawn, ``_draw_eval_seed`` the eval
episodes'. On a device env a rollout seed seeds a generator on the device
(``_episode_starts``) for the episodes' reset states, action noise and
obs-stat sampling.

Not ported yet: quota mode (episodes/timesteps per batch) and the JAX
package's ``_update_and_eval``, mirrored pairs (``mirror_crn``), obs stats
on the host engine, VINE dumps.
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
from ..models.mlp import MLPContext
from ..ops import fitness, obstat, optim
from ..ops.noise import NoiseTable
from ..ops.noise_gradient import noise_gradient
from ..utils import tabular as tlogger
from .rollout import collect_ref_batch, paired_reset, rollout_batch
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
    calc_obstat_prob: float = 0.0  # share of rollouts feeding the obs stats (es.py:356-363)


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
    bc: np.ndarray  # [n, 2, bc_dim] the rollouts' final-state behavior characterizations


def pair_columns(x: np.ndarray, npairs: int) -> np.ndarray:
    """``[n, 2, ...]`` from the first ``2n`` slots: (θ+σε, θ−σε) per pair."""
    return np.stack([x[:npairs], x[npairs : 2 * npairs]], axis=1)


class ESTrainer:
    """Fixed-population ES on a host-engine env or a device env."""

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
        if config.population_size <= 0:
            raise NotImplementedError("only fixed-population mode (population_size > 0) is ported yet")
        self.is_host_env = getattr(env, "is_host_env", False)
        if self.is_host_env and model.needs_ob_stat:
            raise NotImplementedError("obs stats on the host engine are not ported yet")
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
            if self.is_host_env:
                self.ref_batch = collect_ref_batch_host(env, self._draw_seed(), self.device)
            else:
                self.ref_batch = collect_ref_batch(env, self._episode_gen(self._draw_seed()), self.device)
        self.opt_state = self.optimizer.init(model.num_params, self.device)
        self.ob_stat = obstat.init(env.obs_shape, eps=1e-2, device=self.device)  # es.py:155-158
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

    def _episode_gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _episode_starts(self, seed: int, n: int, paired: bool):
        """Device env: the reset state of ``n`` episodes (twice over, the
        halves alike, when ``paired``) and the generator that the episodes'
        other draws come from, both from the rollout seed."""
        gen = self._episode_gen(seed)
        state = paired_reset(self.env, n, gen, self.device) if paired else self.env.reset(n, gen, self.device)
        return state, gen

    # -------------------------------------------------------------- rounds

    def _npairs_round(self) -> int:
        """Pairs a round evaluates: the population's, capped by the θ
        budget and, on the host engine, by the slot count."""
        cfg = self.config
        cap = max(1, int(cfg.theta_hbm_budget) // (2 * self.model.num_params * 4))
        npairs = min(cfg.population_size // 2, cap)
        if self.is_host_env:
            npairs = min(npairs, self.env.batch_size // 2)
        return max(npairs, 1)

    def _perturbed(self, idxs: torch.Tensor) -> torch.Tensor:
        """``[2n, D]``: θ + σε for each offset, then θ − σε."""
        eps = self.noise.get_batch(idxs.to(self.device), self.model.num_params)
        sigma = self.config.noise_stdev
        return torch.cat([self.theta[None] + sigma * eps, self.theta[None] - sigma * eps])

    def _model_ctx(self, noisy: bool, gen: Optional[torch.Generator] = None, paired: bool = False):
        """Context of a device rollout: the obs stats' mean and std, and
        action noise on in training rollouts (es.py:415-421 → policies.py:
        202-206), off in eval ones (es.py:393)."""
        if not self.model.needs_ob_stat:
            return None
        return MLPContext(obstat.mean(self.ob_stat), obstat.std(self.ob_stat), 1.0 if noisy else 0.0, gen, paired)

    def _host_rollout(self, npairs: int, collect_bc_traj: bool = False):
        """θ±σε for ``npairs`` pairs on the first ``2·npairs`` engine slots;
        the reference stats are computed for those members only, and
        unused slots run copies of the last member and its stats. Returns
        (idxs, the engine's RolloutResult over every slot)."""
        idxs, seed = self._draw_round(npairs)
        thetas = self._perturbed(idxs)
        with record_function("es.ref_stats"):
            stats = self.model.batch_ref_stats(thetas, self.ref_batch) if self.model.needs_ref_batch else None
        if 2 * npairs < self.env.batch_size:
            pad = self.env.batch_size - 2 * npairs
            thetas = torch.cat([thetas, thetas[-1:].expand(pad, -1)])
            if stats is not None:
                stats = type(stats)(*(tuple(torch.cat([x, x[-1:].expand(pad, -1)]) for x in f) for f in stats))
        with record_function("es.rollout"):
            res = rollout_host_batch(
                self.env, self.model.make_batch_act(), (thetas, stats), seed, int(self.cutoff.tslimit), self.device,
                collect_bc_traj=collect_bc_traj,
            )
        return idxs, res

    def _host_round(self, npairs: int):
        """One antithetic round (``_host_rollout``). Returns (idxs, returns
        [n,2], sign returns [n,2], lengths [n,2], bc [n,2,·]) as numpy."""
        idxs, res = self._host_rollout(npairs)
        return idxs, *(pair_columns(x, npairs) for x in (res.returns, res.sign_returns, res.lengths, res.bc))

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

    def _device_params(self, thetas: torch.Tensor, ctx):
        if self.model.needs_ref_batch:
            return thetas, self.model.batch_ref_stats(thetas, self.ref_batch)
        return thetas, ctx

    def _device_round(self, npairs: int, obstat_prob: Optional[float]):
        """One antithetic round on the device env (the JAX package's
        ``_perturbed_round_body``): 2·npairs slots, pairs from one reset
        state. Returns (idxs, returns [n,2], sign returns [n,2], lengths
        [n,2], bc [n,2,·], ob_sum, ob_sumsq, ob_count), on the device but
        idxs."""
        idxs, seed = self._draw_round(npairs)
        state, gen = self._episode_starts(seed, npairs, paired=True)
        thetas = self._perturbed(idxs)
        with record_function("es.ref_stats"):
            params = self._device_params(thetas, self._model_ctx(True, gen, paired=True))
        mask = None
        if obstat_prob is not None:  # each rollout joins with probability p (es.py:356-363)
            mask = (torch.rand(2 * npairs, generator=gen, device=gen.device) < obstat_prob).to(torch.float32)
        with record_function("es.rollout"):
            res = rollout_batch(
                self.env, self.model.make_batch_act(), params, state, int(self.cutoff.tslimit), True, mask
            )
        pair = lambda x: torch.stack([x[:npairs], x[npairs:]], dim=1)  # noqa: E731
        return (idxs, pair(res.returns), pair(res.sign_returns), pair(res.lengths), pair(res.bc),
                res.ob_sum, res.ob_sumsq, res.ob_count)

    def _device_eval(self, seed: int):
        """``num_eval_episodes`` noiseless episodes of θ on the device env,
        each from its own reset state (the JAX package's
        ``_eval_theta_body``). Returns (returns [n], lengths [n]) on the
        device."""
        n = self.config.num_eval_episodes
        state, gen = self._episode_starts(seed, n, paired=False)
        thetas = self.theta[None].expand(n, -1)
        if self.model.needs_ref_batch:
            one = self.model.batch_ref_stats(self.theta[None], self.ref_batch)
            params = thetas, type(one)(*(tuple(x.expand(n, -1) for x in f) for f in one))
        else:
            params = thetas, self._model_ctx(False, gen)
        res = rollout_batch(self.env, self.model.make_batch_act(), params, state, int(self.cutoff.tslimit))
        return res.returns, res.lengths

    # ---------------------------------------------------------- generation

    def _process_returns(self, rets: torch.Tensor, srets: torch.Tensor) -> torch.Tensor:
        """The [n, 2] weights of the pairs' members (es.py:281-288)."""
        return fitness.process_returns(rets, srets, self.config.return_proc_mode)

    def _compute_update(self, noise_idxs: torch.Tensor, returns_n2, signreturns_n2):
        """Rank transform → gradient (K2) → L2 → optimizer step, from [n, 2]
        returns (numpy or tensors). Returns (g, new opt state, new θ, update
        ratio)."""
        cfg = self.config
        rets = torch.as_tensor(returns_n2, device=self.device)
        srets = torch.as_tensor(signreturns_n2, device=self.device)
        proc = self._process_returns(rets, srets)
        w = (proc[:, 0] - proc[:, 1]).contiguous()
        g = noise_gradient(self.noise.noise, noise_idxs.to(self.device, torch.int32).contiguous(), w, self.model.num_params)
        g = g / rets.numel()  # es.py:296
        opt_state, theta, ratio = self.optimizer.update(self.opt_state, self.theta, -g + cfg.l2coeff * self.theta)
        return g, opt_state, theta, ratio

    def train_step(self) -> GenStats:
        return self._host_generation() if self.is_host_env else self._device_generation()

    def _host_generation(self) -> GenStats:
        cfg = self.config
        step_tstart = time.time()
        eval_seed = self._draw_eval_seed() if cfg.num_eval_episodes > 0 else None
        npairs = self._npairs_round()
        rounds = []
        episodes = 0
        while episodes < cfg.population_size:
            rounds.append(self._host_round(npairs))
            episodes += rounds[-1][3].size
        idxs, *columns = zip(*rounds)
        noise_idxs = torch.cat(idxs)
        returns_n2, srets_n2, lengths_n2, bc_n2 = (np.concatenate(c) for c in columns)
        with record_function("es.update"):
            g, opt_state, theta, ratio = self._compute_update(noise_idxs, returns_n2, srets_n2)
        gnorm = float(torch.sum(g * g))
        eval_rets, eval_lens = np.zeros(0, np.float32), np.zeros(0, np.int32)
        if eval_seed is not None:
            with record_function("es.eval"):
                eval_rets, eval_lens = self._host_eval(eval_seed)  # θ before the update
        return self._finalize_generation(
            opt_state, theta, float(ratio), gnorm, returns_n2, lengths_n2, bc_n2, eval_rets, eval_lens, 0.0,
            step_tstart,
        )

    def _device_generation(self) -> GenStats:
        """The JAX package's ``_fused_generation`` order: the rounds, the
        update from their returns, the eval episodes of the pre-update θ;
        then one read of the results on the host, and the obs-stat merge."""
        cfg = self.config
        step_tstart = time.time()
        eval_seed = self._draw_eval_seed() if cfg.num_eval_episodes > 0 else None
        total_pairs = max(cfg.population_size // 2, 1)
        npairs = min(self._npairs_round(), total_pairs)
        p = cfg.calc_obstat_prob
        obstat_prob = p if self.model.needs_ob_stat and 0.0 < p < 1.0 else None
        rounds = [self._device_round(npairs, obstat_prob) for _ in range(-(-total_pairs // npairs))]
        idxs = torch.cat([r[0] for r in rounds])
        rets, srets, lens, bcs = (torch.cat([r[i] for r in rounds]) for i in range(1, 5))
        ob_sum, ob_sumsq, ob_count = (sum(r[i] for r in rounds) for i in range(5, 8))
        with record_function("es.update"):
            g, opt_state, theta, ratio = self._compute_update(idxs, rets, srets)
        eval_rets = eval_lens = torch.zeros(0, device=self.device)
        if eval_seed is not None:
            with record_function("es.eval"):
                eval_rets, eval_lens = self._device_eval(eval_seed)  # θ before the update
        gnorm = torch.sum(g * g)
        rets, lens, bcs, eval_rets, eval_lens, gnorm, ratio, count = (
            x.cpu().numpy() for x in (rets, lens, bcs, eval_rets, eval_lens, gnorm, ratio, ob_count)
        )
        if self.model.needs_ob_stat and count > 0 and p > 0:  # es.py:246-248
            self.ob_stat = obstat.increment(self.ob_stat, ob_sum, ob_sumsq, ob_count)
        return self._finalize_generation(
            opt_state, theta, float(ratio), float(gnorm), rets, lens, bcs, eval_rets, eval_lens, float(count),
            step_tstart,
        )

    def _finalize_generation(
        self, opt_state, theta, ratio, gnorm, returns_n2, lengths_n2, bc_n2, eval_rets, eval_lens, ob_count,
        step_tstart,
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
        tlogger.record_tabular("ObCount", ob_count)
        tlogger.record_tabular("TimeElapsedThisIter", step_tend - step_tstart)
        tlogger.record_tabular("TimeElapsed", step_tend - self._tstart)
        tlogger.record_tabular(
            "TimestepsPerSecondThisIter", int(lengths_n2.sum()) / max(step_tend - step_tstart, 1e-9)
        )
        tlogger.dump_tabular()
        self.last_stats = GenStats(
            returns_n2, lengths_n2, gnorm, ratio, step_tend - step_tstart, eval_rets, eval_lens, bc_n2
        )
        return self.last_stats

    def train(self, iterations: int):
        for _ in range(iterations):
            self.train_step()

    def close(self) -> None:
        """Stop the host engine's threads (a device env holds none)."""
        if self.is_host_env:
            self.env.close()
