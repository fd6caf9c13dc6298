"""Evolution Strategies in fixed-population and quota mode, on the host
engine or a device env.

The counterpart of the JAX package's algos/es.py ``ESTrainer``, after
es_distributed/es.py and gpu_implementation/es.py:

* antithetic pairs θ ± σε, with ε a noise-table row at a sampled offset
  (es.py:411-426);
* a generation of ``population_size`` episodes (fixed-population mode), or
  in quota mode (``episodes_per_batch`` or ``timesteps_per_batch`` > 0)
  rounds until both quotas are met (es.py:230); a round is ``eval_batch``
  pairs, else the population's (64 in quota mode), capped so the
  ``[2·pairs, D]`` θ batch stays under ``theta_hbm_budget`` bytes of device
  memory (and, on the host engine, by the slot count: the JAX package's
  ``_npairs_round``);
* VBN reference stats per perturbed member, from a reference batch that a
  random policy collects once (es.py:159-162);
* centered ranks, g = Σ(w⁺−w⁻)ᵢ·εᵢ / (2n) through kernel K2 (``grad_chunk``
  pairs at a time in its plain version), and the optimizer step on
  −g + l2coeff·θ (es.py:281-301). On a ``VirtualNoise`` (the loader's
  ``noise: virtual``) ε is regenerated, ``grad_chunk`` rows at a time, and
  K2, which reads a table, takes no part (the JAX package's es.py:335);
* the episode-cutoff DSL and its adaptive bump (es.py:169-186, 308-311);
* ``num_eval_episodes`` noiseless episodes of the pre-update θ each
  generation (es.py:388-405), logged as the reference's ``Eval*`` metrics;
* the reference's tabular metric names (es.py:314-343);
* with ``vine_snapshot_dir``, the VINE dumps of each generation
  (es_modified.py:140-199; utils/vine.py): a row per rollout, with its
  engine episode seed (host engine) or its round's rollout seed (device
  env), and the parent's row, policy file and reference batch.

Two arms run a round. The host arm (``_host_round``, ``_host_eval``)
drives the C++ engine through algos/rollout_host.py. The device arm
(``_device_round``, ``_device_eval``; the JAX package's
``_perturbed_round_body``, ``_eval_theta_body`` and ``_fused_generation``'s
order) steps a device env in lockstep with the population forward
(algos/rollout.py): pairs start from one reset state and share their
action noise; every rollout's observations go into obs-stat sums, each
rollout with probability ``calc_obstat_prob`` when it lies in (0, 1); the
sums merge into the running stats when the model normalizes observations
and ``calc_obstat_prob`` > 0 (es.py:246-248, 356-363). A fixed-population
generation reads the device's results on the host once, after its update
and eval episodes. In quota mode the device arm follows the JAX package's
:722-776: it estimates the rounds both quotas need from the last mean
episode length (``_mean_len_est``, the cutoff at first), runs them, reads
their lengths, and tops up until both quotas are met; then the update and
the eval episodes of the pre-update θ (``_update_and_eval``'s order).

``mirror_crn`` (Atari engine): a pair's θ+σε and θ−σε share the noop count
and the engine episode seed (rollout_host.py ``mirror_pairs``). On a device
env a pair always starts from one reset state, so it changes nothing there.

The host arm runs the Atari engine and the vector engines (MuJoCo) through
rollout_host.py's ``rollout_host``. A model that normalizes observations
(the MujocoMLP) gets the obs stats' mean and std in its context and, in a
training round, action noise from a generator on the device seeded with
the round's rollout seed, every slot its own draws (the JAX package's
per-slot keys; unlike the device arm, a pair does not share them). The
round's obs sums (each rollout with probability ``calc_obstat_prob`` when
it lies in (0, 1), the padded copies of the last member left out) merge
into the running stats after the update, as on the device arm.

Host-side draws (θ init, noise offsets, rollout seeds) come from one CPU
``torch.Generator`` seeded with ``seed``; ``_draw_round`` is the single
place a round's randomness is drawn, ``_draw_eval_seed`` the eval
episodes' (every generation, whether or not any run). On a device env a
rollout seed seeds a generator on the device (``_episode_starts``) for
the episodes' reset states, action noise and obs-stat sampling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.core import Model
from ..models.mlp import MLPContext
from ..ops import fitness, obstat, optim
from ..ops.noise import NoiseTable, VirtualNoise
from ..ops.noise_gradient import noise_gradient
from ..utils import tabular as tlogger
from ..utils import vine
from ..utils.trace import span
from .rollout import collect_ref_batch, index_state, paired_reset, rollout_batch
from .rollout_host import collect_ref_batch_host, rollout_host


@dataclasses.dataclass
class ESConfig:
    """The reference Config fields this mode uses, plus engine knobs."""

    l2coeff: float = 0.005
    noise_stdev: float = 0.02
    population_size: int = 0  # episodes per generation (gpu es.py:197)
    episodes_per_batch: int = 0  # quota mode when either quota > 0 (es.py:230)
    timesteps_per_batch: int = 0
    eval_prob: float = 0.0  # the CPU stack's field; the loader turns it into num_eval_episodes
    snapshot_freq: int = 0  # the CPU stack's field; ``main train --snapshot_freq`` sets the CLI's
    return_proc_mode: str = "centered_rank"
    episode_cutoff_mode: Any = "env_default"
    num_eval_episodes: int = 8  # noiseless episodes of θ per generation
    theta_hbm_budget: int = 2**31  # bytes allowed for one round's [2·pairs, D] θ batch
    calc_obstat_prob: float = 0.0  # share of rollouts feeding the obs stats (es.py:356-363)
    eval_batch: int = 0  # pairs a round evaluates (0: the population's, 64 in quota mode)
    mirror_crn: bool = False  # host engine: a pair's members share noops and engine episode seed
    grad_chunk: int = 256  # pairs the gradient's plain version gathers at a time (K2 has no chunk)
    vine_snapshot_dir: str = ""  # per-generation VINE dumps under this directory (es_modified.py)


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

    writes = True  # VINE dumps; a pod's ranks but rank 0 write nothing

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
        self.is_host_env = getattr(env, "is_host_env", False)
        self.device = resolve_device(device)
        self.env = env
        self.model = model
        self.config = config
        self.optimizer = optimizer or optim.Adam(stepsize=0.01)
        self.gen = torch.Generator().manual_seed(seed)
        self.noise = (noise_table or NoiseTable.from_seed(device=self.device)).to(self.device)
        if self.noise.size <= model.num_params:
            raise ValueError(f"noise table ({self.noise.size}) must exceed num_params ({model.num_params})")
        self.theta = model.init_theta(self.gen, self.device)
        self.cutoff = parse_cutoff(config.episode_cutoff_mode, env.default_timestep_cutoff)
        self.ref_batch = self._collect_ref_batch(self._draw_seed()) if model.needs_ref_batch else None
        self.opt_state = self.optimizer.init(model.num_params, self.device)
        self.ob_stat = obstat.init(env.obs_shape, eps=1e-2, device=self.device)  # es.py:155-158
        self.iteration = 0
        self.episodes_so_far = 0
        self.timesteps_so_far = 0
        self._mean_len_est = float(self.cutoff.tslimit)  # quota mode's episode-length estimate
        self.last_dispatches: list = []  # quota mode, device env: the rounds of each estimate
        self.last_stats: Optional[GenStats] = None
        self._tstart = time.time()

    def _collect_ref_batch(self, seed: int) -> torch.Tensor:
        """The VBN reference batch a random policy collects, from a seed."""
        if self.is_host_env:
            return collect_ref_batch_host(self.env, seed, self.device)
        return collect_ref_batch(self.env, self._episode_gen(seed), self.device)

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

    @property
    def quota_mode(self) -> bool:
        return self.config.episodes_per_batch > 0 or self.config.timesteps_per_batch > 0

    def _npairs_round(self) -> int:
        """Pairs a round evaluates (the JAX package's es.py:616-629):
        ``eval_batch`` when set; else the population's, or 64 in quota mode,
        capped by the θ budget; on the host engine, at most half the
        slots."""
        cfg = self.config
        cap = max(1, int(cfg.theta_hbm_budget) // (2 * self.model.num_params * 4))
        if cfg.eval_batch:
            npairs = cfg.eval_batch
        elif cfg.population_size:
            npairs = min(max(cfg.population_size // 2, 1), cap)
        else:
            npairs = min(64, cap)
        if self.is_host_env:
            npairs = min(npairs, self.env.batch_size // 2)
        return max(npairs, 1)

    def _quotas_met(self, episodes: int, timesteps: int) -> bool:
        return episodes >= self.config.episodes_per_batch and timesteps >= self.config.timesteps_per_batch

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

    def _obstat_args(self) -> dict:
        """Whether a training round collects obs sums, and each rollout's
        probability of joining them (es.py:356-363; None: every rollout)."""
        p = self.config.calc_obstat_prob
        return dict(collect_obstat=self.model.needs_ob_stat and p > 0, obstat_prob=p if 0.0 < p < 1.0 else None)

    def _host_params(self, thetas: torch.Tensor, noisy: bool, seed: int, ob_stat=None):
        """``(thetas, stats or context)`` of a host rollout: a VBN model's
        reference stats (one member's, expanded, when every row is θ), an
        obs-normalizing model's context (action noise from a device
        generator seeded with ``seed`` when ``noisy``), else None."""
        if self.model.needs_ref_batch:
            if noisy:
                return thetas, self.model.batch_ref_stats(thetas, self.ref_batch)
            one = self.model.batch_ref_stats(thetas[:1], self.ref_batch)
            n = thetas.shape[0]
            return thetas, type(one)(*(tuple(x.expand(n, -1) for x in f) for f in one))
        if self.model.needs_ob_stat:
            st = self.ob_stat if ob_stat is None else ob_stat
            gen = self._episode_gen(seed) if noisy else None
            return thetas, MLPContext(obstat.mean(st), obstat.std(st), 1.0 if noisy else 0.0, gen, False)
        return thetas, None

    def _host_rollout(self, npairs: int, collect_bc_traj: bool = False, draws=None):
        """θ±σε for ``npairs`` pairs on the first ``2·npairs`` engine slots;
        the reference stats are computed for those members only, and
        unused slots run copies of the last member and its stats, left out
        of the obs sums; with ``mirror_crn`` a pair's slots share their
        draws. ``draws`` is the round's ``_draw_round`` when the caller made
        it. Returns (idxs, the engine's RolloutResult over every slot)."""
        idxs, seed = draws if draws is not None else self._draw_round(npairs)
        thetas = self._perturbed(idxs)
        with span("es.ref_stats"):
            thetas, stats = self._host_params(thetas, True, seed)
        B, valid = self.env.batch_size, None
        if 2 * npairs < B:
            pad = B - 2 * npairs
            thetas = torch.cat([thetas, thetas[-1:].expand(pad, -1)])
            if self.model.needs_ref_batch:
                stats = type(stats)(*(tuple(torch.cat([x, x[-1:].expand(pad, -1)]) for x in f) for f in stats))
            valid = np.arange(B) < 2 * npairs
        with span("es.rollout"):
            res = rollout_host(
                self.env, self.model.make_batch_act(), (thetas, stats), seed, int(self.cutoff.tslimit), self.device,
                collect_bc_traj=collect_bc_traj, mirror_pairs=npairs if self.config.mirror_crn else 0,
                obstat_valid=valid, **self._obstat_args(),
            )
        return idxs, res

    def _ob_sums(self, res):
        """A rollout's obs sums on the device (None, None, 0.0 when it
        collected none)."""
        if res.ob_sum is None:
            return None, None, 0.0
        to = lambda x: torch.from_numpy(x).to(self.device)  # noqa: E731
        return to(res.ob_sum), to(res.ob_sumsq), float(res.ob_count)

    def _host_round(self, npairs: int, draws=None):
        """One antithetic round (``_host_rollout``). Returns (idxs, returns
        [n,2], sign returns [n,2], lengths [n,2], bc [n,2,·], engine episode
        seeds [n,2]) as numpy, then ob_sum, ob_sumsq (device tensors or
        None) and ob_count."""
        idxs, res = self._host_rollout(npairs, draws=draws)
        return (idxs, *(pair_columns(x, npairs) for x in (res.returns, res.sign_returns, res.lengths, res.bc,
                                                           res.ep_seeds)), *self._ob_sums(res))

    def _host_eval(self, seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Noiseless episodes of θ on the first ``n = min(num_eval_episodes,
        slots)`` engine slots, every slot with θ and one member's reference
        stats (es.py:588-611), or the obs stats. Returns (returns [n],
        lengths [n], bc [n, ·])."""
        n = min(self.config.num_eval_episodes, self.env.batch_size)
        params = self._host_params(self.theta[None].expand(n, -1), False, seed)
        res = rollout_host(self.env, self.model.make_batch_act(), params, seed, int(self.cutoff.tslimit), self.device,
                           n_slots=n)
        return res.returns[:n], res.lengths[:n], res.bc[:n]

    def _device_params(self, thetas: torch.Tensor, ctx):
        if self.model.needs_ref_batch:
            return thetas, self.model.batch_ref_stats(thetas, self.ref_batch)
        return thetas, ctx

    def _device_round(self, npairs: int, obstat_prob: Optional[float], draws=None):
        """One antithetic round on the device env (the JAX package's
        ``_perturbed_round_body``): 2·npairs slots, pairs from one reset
        state; ``draws`` as in ``_host_rollout``. Returns (idxs, returns
        [n,2], sign returns [n,2], lengths [n,2], bc [n,2,·], ob_sum,
        ob_sumsq, ob_count, the rollout seed), on the device but idxs and
        the seed."""
        idxs, seed = draws if draws is not None else self._draw_round(npairs)
        state, gen = self._episode_starts(seed, npairs, paired=True)
        thetas = self._perturbed(idxs)
        with span("es.ref_stats"):
            params = self._device_params(thetas, self._model_ctx(True, gen, paired=True))
        mask = None
        if obstat_prob is not None:  # each rollout joins with probability p (es.py:356-363)
            mask = (torch.rand(2 * npairs, generator=gen, device=gen.device) < obstat_prob).to(torch.float32)
        with span("es.rollout"):
            res = rollout_batch(
                self.env, self.model.make_batch_act(), params, state, int(self.cutoff.tslimit), True, mask
            )
        pair = lambda x: torch.stack([x[:npairs], x[npairs:]], dim=1)  # noqa: E731
        return (idxs, pair(res.returns), pair(res.sign_returns), pair(res.lengths), pair(res.bc),
                res.ob_sum, res.ob_sumsq, res.ob_count, seed)

    def _device_eval(self, seed: int, rows: Optional[Tuple[int, int]] = None):
        """``num_eval_episodes`` noiseless episodes of θ on the device env,
        each from its own reset state (the JAX package's
        ``_eval_theta_body``); ``rows = (lo, hi)`` runs only those episodes
        of the ``n``, from the same reset states. Returns (returns, lengths,
        bc [·, bc_dim]) on the device."""
        n = self.config.num_eval_episodes
        state, gen = self._episode_starts(seed, n, paired=False)
        if rows is not None:
            state = index_state(state, torch.arange(*rows, device=state[0].device))
            n = rows[1] - rows[0]
        thetas = self.theta[None].expand(n, -1)
        if self.model.needs_ref_batch:
            one = self.model.batch_ref_stats(self.theta[None], self.ref_batch)
            params = thetas, type(one)(*(tuple(x.expand(n, -1) for x in f) for f in one))
        else:
            params = thetas, self._model_ctx(False, gen)
        res = rollout_batch(self.env, self.model.make_batch_act(), params, state, int(self.cutoff.tslimit))
        return res.returns, res.lengths, res.bc

    # ---------------------------------------------------------- generation

    def _process_returns(self, rets: torch.Tensor, srets: torch.Tensor) -> torch.Tensor:
        """The [n, 2] weights of the pairs' members (es.py:281-288)."""
        return fitness.process_returns(rets, srets, self.config.return_proc_mode)

    def _compute_update(self, noise_idxs: torch.Tensor, returns_n2, signreturns_n2):
        """Rank transform → gradient (K2 on a table) → L2 → optimizer step, from [n, 2]
        returns (numpy or tensors). Returns (g, new opt state, new θ, update
        ratio)."""
        cfg = self.config
        rets = torch.as_tensor(returns_n2, device=self.device)
        srets = torch.as_tensor(signreturns_n2, device=self.device)
        proc = self._process_returns(rets, srets)
        w = (proc[:, 0] - proc[:, 1]).contiguous()
        idxs = noise_idxs.to(self.device, torch.int32).contiguous()
        g = self._noise_gradient(idxs, w) / rets.numel()  # es.py:296
        opt_state, theta, ratio = self.optimizer.update(self.opt_state, self.theta, -g + cfg.l2coeff * self.theta)
        return g, opt_state, theta, ratio

    def _noise_gradient(self, idxs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Σᵢ wᵢ·εᵢ over the rows at ``idxs``: K2 on a table; on a
        ``VirtualNoise`` the rows regenerated, without K2 (es.py:335)."""
        D, chunk = self.model.num_params, self.config.grad_chunk
        if isinstance(self.noise, VirtualNoise):
            return fitness.gradient_from_noise(self.noise, idxs, w, D, chunk)
        return noise_gradient(self.noise.noise, idxs, w, D, chunk)

    def train_step(self) -> GenStats:
        return self._host_generation() if self.is_host_env else self._device_generation()

    def _host_generation(self) -> GenStats:
        """Rounds until the population (or both quotas) is met (the JAX
        package's :772-801), the update from their returns, the eval
        episodes of the pre-update θ."""
        cfg = self.config
        step_tstart = time.time()
        # drawn with or without eval episodes, as the JAX package splits keval
        # (es.py:661): θ's draws never depend on the eval count
        seed = self._draw_eval_seed()
        eval_seed = seed if cfg.num_eval_episodes > 0 else None
        npairs = self._npairs_round()
        target = cfg.population_size or 2 * npairs
        rounds = []
        episodes = timesteps = 0
        while True:
            rounds.append(self._host_round(npairs))
            episodes += rounds[-1][3].size
            timesteps += int(rounds[-1][3].sum())
            if self._quotas_met(episodes, timesteps) if self.quota_mode else episodes >= target:
                break
        noise_idxs = torch.cat([r[0] for r in rounds])
        returns_n2, srets_n2, lengths_n2, bc_n2, seeds_n2 = (np.concatenate([r[i] for r in rounds])
                                                             for i in range(1, 6))
        with span("es.update"):
            g, opt_state, theta, ratio = self._compute_update(noise_idxs, returns_n2, srets_n2)
        gnorm = float(torch.sum(g * g))
        eval_rets, eval_lens, eval_bc = np.zeros(0, np.float32), np.zeros(0, np.int32), None
        if eval_seed is not None:
            with span("es.eval"):
                eval_rets, eval_lens, eval_bc = self._host_eval(eval_seed)  # θ before the update
        ob_count = self._merge_ob_sums(rounds)
        return self._finalize_generation(
            opt_state, theta, float(ratio), gnorm, returns_n2, lengths_n2, bc_n2, eval_rets, eval_lens, ob_count,
            step_tstart, noise_idxs, seeds_n2, eval_bc, eval_seed,
        )

    def _merge_ob_sums(self, rounds) -> float:
        """The rounds' obs sums (columns 6-8), added in round order from
        zero, into the running stats when the model keeps them and
        ``calc_obstat_prob`` > 0 (es.py:246-248). Returns the count."""
        count = sum(r[8] for r in rounds)
        if rounds[0][6] is not None and self.model.needs_ob_stat and count > 0 and self.config.calc_obstat_prob > 0:
            ob_sum, ob_sumsq = (sum(r[i] for r in rounds) for i in (6, 7))
            self.ob_stat = obstat.increment(self.ob_stat, ob_sum, ob_sumsq, count)
        return float(count)

    def _device_rounds(self, npairs: int, obstat_prob: Optional[float]) -> list:
        """A generation's rounds on the device env: a fixed population's
        ⌈pairs / npairs⌉, or in quota mode the JAX package's estimate of the
        rounds both quotas need and the top-ups (:722-776), one read of the
        rounds' lengths on the host each."""
        cfg = self.config
        if not self.quota_mode:
            total_pairs = max((cfg.population_size or 2 * npairs) // 2, 1)
            return [self._device_round(npairs, obstat_prob) for _ in range(-(-total_pairs // npairs))]
        rounds, episodes, timesteps = [], 0, 0
        self.last_dispatches = []
        while True:
            rem_ep = max(cfg.episodes_per_batch - episodes, 0)
            rem_ts = max(cfg.timesteps_per_batch - timesteps, 0)
            r_ep = -(-rem_ep // (2 * npairs)) if rem_ep else 0
            r_ts = -(-rem_ts // int(2 * npairs * max(self._mean_len_est, 1.0))) if rem_ts else 0
            n = max(r_ep, r_ts, 1 if episodes == 0 else 0)
            if n == 0:
                break
            batch = [self._device_round(npairs, obstat_prob) for _ in range(n)]
            lens = torch.cat([r[3] for r in batch])
            rounds += batch
            self.last_dispatches.append(n)
            episodes += 2 * npairs * n
            timesteps += int(lens.sum())
            self._mean_len_est = max(float(lens.double().mean()), 1.0)
            if self._quotas_met(episodes, timesteps):
                break
        return rounds

    def _device_generation(self) -> GenStats:
        """The JAX package's ``_fused_generation`` order (quota mode:
        ``_update_and_eval``'s): the rounds, the update from their returns,
        the eval episodes of the pre-update θ; then one read of the results
        on the host, and the obs-stat merge."""
        cfg = self.config
        step_tstart = time.time()
        # drawn with or without eval episodes, as the JAX package splits keval
        # (es.py:661): θ's draws never depend on the eval count
        seed = self._draw_eval_seed()
        eval_seed = seed if cfg.num_eval_episodes > 0 else None
        npairs = self._npairs_round()
        if not self.quota_mode:
            npairs = min(npairs, max((cfg.population_size or 2 * npairs) // 2, 1))
        p = cfg.calc_obstat_prob
        obstat_prob = p if self.model.needs_ob_stat and 0.0 < p < 1.0 else None
        rounds = self._device_rounds(npairs, obstat_prob)
        idxs = torch.cat([r[0] for r in rounds])
        rets, srets, lens, bcs = (torch.cat([r[i] for r in rounds]) for i in range(1, 5))
        ob_sum, ob_sumsq, ob_count = (sum(r[i] for r in rounds) for i in range(5, 8))
        # a round's rollout seed, or a seed a pair (a pod's rounds)
        seeds_n2 = np.concatenate([np.broadcast_to(np.asarray(r[8], np.int64), (r[0].shape[0],)) for r in rounds])
        seeds_n2 = seeds_n2[:, None].repeat(2, axis=1)
        with span("es.update"):
            g, opt_state, theta, ratio = self._compute_update(idxs, rets, srets)
        eval_rets = eval_lens = eval_bc = torch.zeros(0, device=self.device)
        if eval_seed is not None:
            with span("es.eval"):
                eval_rets, eval_lens, eval_bc = self._device_eval(eval_seed)  # θ before the update
        gnorm = torch.sum(g * g)
        rets, lens, bcs, eval_rets, eval_lens, eval_bc, gnorm, ratio, count = (
            x.cpu().numpy() for x in (rets, lens, bcs, eval_rets, eval_lens, eval_bc, gnorm, ratio, ob_count)
        )
        if self.model.needs_ob_stat and count > 0 and p > 0:  # es.py:246-248
            self.ob_stat = obstat.increment(self.ob_stat, ob_sum, ob_sumsq, ob_count)
        return self._finalize_generation(
            opt_state, theta, float(ratio), float(gnorm), rets, lens, bcs, eval_rets, eval_lens, float(count),
            step_tstart, idxs, seeds_n2, eval_bc, eval_seed,
        )

    def _finalize_generation(
        self, opt_state, theta, ratio, gnorm, returns_n2, lengths_n2, bc_n2, eval_rets, eval_lens, ob_count,
        step_tstart, noise_idxs, seeds_n2, eval_bc, eval_seed,
    ) -> GenStats:
        """State swap, cutoff curriculum, the reference-named metrics and
        the VINE dumps."""
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
        if self.config.vine_snapshot_dir and self.writes:
            vine.master_extract_cloud(self.config.vine_snapshot_dir, self.iteration, bc_n2, returns_n2, lengths_n2,
                                      noise_idxs.numpy(), seeds_n2)
            vine.master_extract_parent(
                self.config.vine_snapshot_dir, self.iteration, eval_bc, eval_rets, eval_lens, self.config.noise_stdev,
                model=self.model, theta=theta, ref_batch=self.ref_batch, seed=eval_seed or 0,
            )
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
