"""Deep GA and random search over seed-chain genomes, on the host engine or
a device env.

The counterpart of the JAX package's algos/ga.py, after the GPU stack's GA
loop (gpu_implementation/ga.py:104-280):

* offspring = a uniformly drawn cached parent plus power·ε of a drawn noise
  row (ga.py:122-129); the first generation draws fresh genomes
  θ = ε·scale_by (base.py:121-125);
* fitness = one episode each, in rounds capped so one round's ``[chunk, D]``
  f32 θ stays under ``theta_hbm_budget`` bytes: on the engine's slots (the
  Atari engine or a vector engine, through ``rollout_host``), each round
  padded to a power-of-two slot bucket (``_eval_host``), or on a
  device env in rounds of ``eval_batch`` members (all of them when 0),
  each member's episode from its own reset state (``_eval_device``, the
  JAX package's ``_ga_gen_rounds`` and ``_eval_thetas``, through
  algos/rollout.py); a last round's surplus members are dropped;
* truncation selection (ga.py:180), with the previous ``num_elites`` carried
  over at their recorded scores (es_distributed/ga.py:139-141); the top
  ``validation_threshold`` (the elite forced in) get
  ``num_validation_episodes`` more, the best of them is the elite and gets
  ``num_test_episodes`` test episodes at the env's default cutoff
  (ga.py:186-204); the parents of the next generation are the top
  ``selection_threshold`` with the elite forced in (ga.py:260-271), and
  their θ is cached so every offspring is one mutation away
  (base.py:127-138);
* the reference's tabular metric names (ga.py:564-595 of the JAX package);
* ``copy_population`` (gpu ga.py:75-82, the experiment's
  ``load_population``): a population from either package's trainer
  snapshot or a pickled list of chains;
* with ``vine_snapshot_dir``, the VINE dumps of ga_modified.py:22-64 (a row
  per offspring, the elite's test episodes as the parent).

Genomes (ops/genome.py) are GPU-style chains ``(idx₀, (idx, power), ...)``
(``genome_style='gpu'``) or the CPU stack's bare indices
(``genome_style='cpu'``, es_distributed/ga.py:250-264): θ₀ =
``reinit_theta`` of the raw row, every mutation of power ``noise_stdev``.
Offspring and cached-prefix θ are one fused multiply-add a step, as the JAX
package's jitted steps; a whole CPU-style chain is rebuilt with two
roundings a step, as its eager ``_reconstruct``. The randomness (parent and
noise indices, rollout seeds) comes from one CPU ``torch.Generator`` seeded
with ``seed``; ``_draw_offspring`` and ``_draw_seed`` are the only places
it is drawn, and on a device env a rollout seed seeds the generator of its
round's reset states (``_episode_starts``).

The noise source is a ``NoiseTable`` or a ``VirtualNoise`` (the loader's
``noise: virtual``), whose rows every genome step regenerates (the JAX
package's ``_table_arg``, :250-257); the genome functions take the source
object itself. The pod trainers are in parallel/.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..models.core import Model
from ..ops import genome, schedules
from ..ops.noise import NoiseTable, noise_rows
from ..utils import tabular as tlogger
from ..utils import vine
from .es import parse_cutoff, update_cutoff
from .rollout import collect_ref_batch, rollout_batch
from .rollout_host import collect_ref_batch_host, rollout_host


@dataclasses.dataclass
class GAConfig:
    population_size: int = 1000  # ga_atari_config.json
    selection_threshold: int = 20  # parents kept per generation
    validation_threshold: int = 10  # candidates re-evaluated for the elite choice
    num_validation_episodes: int = 30
    num_test_episodes: int = 200
    num_elites: int = 1  # elite carry-over (es_distributed/ga.py:66-67)
    mutation_power: Any = 0.002  # a number or a schedule dict (helper.py:46-88)
    episode_cutoff_mode: Any = "env_default"
    timesteps: float = 1.5e9  # training budget (ga_atari_config.json)
    eval_batch: int = 0  # device env: members a rollout round evaluates; 0 → all of them
    theta_hbm_budget: int = 2**31  # bytes allowed for one fitness round's [chunk, D] f32 θ
    genome_style: str = "gpu"  # 'gpu' (idx, power) chains | 'cpu' (bare indices, reinit + noise_stdev)
    noise_stdev: float = 0.002  # CPU-style chains' mutation power (frostbite_ga.json)
    vine_snapshot_dir: str = ""  # per-generation VINE dumps under this directory (ga_modified.py:22-64)


class Offspring(NamedTuple):
    """A genome and its record (gpu ga.py:83-99)."""

    seeds: Tuple  # (init_idx, (idx, power), ...), or (init_idx, idx, ...) for CPU-style chains
    fitness: float
    training_steps: int


class GAState:
    """Training state (gpu ga.py:33-82 TrainingState)."""

    def __init__(self):
        self.it = 0
        self.timesteps_so_far = 0
        self.validation_timesteps_so_far = 0
        self.time_elapsed = 0.0
        self.population: List[Offspring] = []
        self.elite: Optional[Offspring] = None
        self.curr_solution: Optional[Tuple] = None
        self.curr_solution_val = float("-inf")
        self.curr_solution_test = float("-inf")


class GATrainer:
    """Deep GA on a host-engine env or a device env."""

    writes = True  # VINE dumps; a pod's ranks but rank 0 write nothing

    def __init__(
        self,
        env,
        model: Model,
        config: GAConfig,
        noise_table: Optional[NoiseTable] = None,
        seed: int = 0,
        device=None,
    ):
        if config.genome_style not in ("gpu", "cpu"):
            raise ValueError(f"unknown genome_style {config.genome_style!r} (gpu|cpu)")
        self.device = resolve_device(device)
        self.is_host_env = getattr(env, "is_host_env", False)
        self.env = env
        self.model = model
        self.config = config
        self.gen = torch.Generator().manual_seed(seed)
        self.noise = (noise_table or NoiseTable.from_seed(device=self.device)).to(self.device)
        if self.noise.size <= model.num_params:
            raise ValueError(f"noise table ({self.noise.size}) must exceed num_params ({model.num_params})")
        self.cutoff = parse_cutoff(config.episode_cutoff_mode, env.default_timestep_cutoff)
        self.state = GAState()
        self.mutation_power = schedules.make_schedule(config.mutation_power)
        self.scale_by = model.scale_by(getattr(model, "scale_style", "fan_in"), self.device)
        self.cached_parent_thetas: Optional[torch.Tensor] = None  # [T, D]
        self.cached_parent_seeds: List[Tuple] = []
        self.ref_batch = self._collect_ref_batch(self._draw_seed()) if model.needs_ref_batch else None

    def _collect_ref_batch(self, seed: int) -> torch.Tensor:
        """The VBN reference batch a random policy collects, from a seed."""
        if self.is_host_env:
            return collect_ref_batch_host(self.env, seed, self.device)
        return collect_ref_batch(self.env, self._episode_gen(seed), self.device)

    # --------------------------------------------------------------- draws

    def _draw_seed(self) -> int:
        """A rollout seed (it seeds the noop counts and engine episode seeds)."""
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.gen))

    def _episode_gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def _episode_starts(self, seed: int, n: int):
        """Device env: the reset states of ``n`` episodes, from a rollout
        seed."""
        return self.env.reset(n, self._episode_gen(seed), self.device)

    def _draw_offspring(self, n: int, n_parents: int) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` (parent index, noise offset) pairs; parent indices are 0
        when there are no parents (fresh genomes)."""
        midx = torch.randint(0, self.noise.size - self.model.num_params + 1, (n,), generator=self.gen)
        pidx = torch.randint(0, n_parents, (n,), generator=self.gen) if n_parents else torch.zeros(n, dtype=torch.int64)
        return pidx.numpy(), midx.numpy()

    def copy_population(self, filename: str) -> None:
        """Imports a population (gpu ga.py:75-82 and :161-162): a trainer
        snapshot of either package (its ``ga.population``) or a pickled list
        of chains or Offspring. Bare-int mutation entries of a GPU-style
        chain become ``(idx, 0.005)``, as the reference migrates them;
        CPU-style chains keep their bare indices; imported chains
        replace the parent cache, so the next generation draws fresh
        genomes and carries the imported elites over."""
        from ..utils.checkpoint import load_pickle

        payload = load_pickle(filename)
        if isinstance(payload, dict):
            payload = payload["ga"]["population"] if "ga" in payload else payload["population"]

        def migrate(seeds):
            seeds = tuple(tuple(s) if isinstance(s, list) else s for s in seeds)
            if self.config.genome_style != "gpu":
                return seeds
            return (seeds[0],) + tuple(s if isinstance(s, tuple) else (s, 0.005) for s in seeds[1:])

        self.state.population = [
            Offspring(migrate(o.seeds), getattr(o, "fitness", float("-inf")), getattr(o, "training_steps", 0))
            if hasattr(o, "seeds") else Offspring(migrate(o), float("-inf"), 0)
            for o in payload
        ]
        self.cached_parent_thetas = None
        self.cached_parent_seeds = []

    # ------------------------------------------------------------- genomes

    def _rows(self, idxs) -> torch.Tensor:
        return noise_rows(self.noise, torch.as_tensor(np.asarray(idxs, np.int64)), self.model.num_params)

    def _offspring_thetas(self, pidx: np.ndarray, midx: np.ndarray, power: float, randomize: bool) -> torch.Tensor:
        """θ = ε·scale_by, or ``reinit_theta(ε)`` for CPU-style genomes
        (fresh), or parents[pidx] + power·ε (base.py:121-125, 148-156),
        rounded as the JAX package rounds them (ops/genome.py); in place on
        the gathered rows but the re-init."""
        eps = self._rows(midx)
        if randomize:
            return self.model.reinit_theta(eps) if self.config.genome_style == "cpu" else eps.mul_(self.scale_by)
        parents = self.cached_parent_thetas[torch.as_tensor(pidx, device=self.device)]
        return genome.mutate_(parents, power, eps)

    def _lookup_theta(self, seeds: Tuple) -> torch.Tensor:
        """θ of a chain: a cached parent, a cached parent plus its last
        mutation (a bare index mutates with ``noise_stdev``), a fresh genome,
        or else the whole chain (base.py:127-145; the JAX package's
        ``_lookup_theta`` and ``_reconstruct``)."""
        dim = self.model.num_params
        if seeds in self.cached_parent_seeds:
            return self.cached_parent_thetas[self.cached_parent_seeds.index(seeds)]
        if len(seeds) > 1 and seeds[:-1] in self.cached_parent_seeds:
            parent = self.cached_parent_thetas[self.cached_parent_seeds.index(seeds[:-1])]
            tail = seeds[-1]
            idx, power = tail if isinstance(tail, tuple) else (tail, self.config.noise_stdev)
            return genome.extend(parent, self.noise, idx, power, dim)
        if self.config.genome_style == "cpu":
            return genome.reconstruct_cpu_style(self.noise, seeds, dim, self.model.reinit_theta,
                                                self.config.noise_stdev)
        if len(seeds) == 1:
            return self._rows([seeds[0]])[0] * self.scale_by
        idxs, powers = genome.pad_chains([seeds], len(seeds))
        return genome.reconstruct_gpu_style(self.noise, idxs[0], powers[0], dim, self.scale_by)

    # ----------------------------------------------------------- evaluation

    def _eval_host(self, thetas: torch.Tensor, tslimit: int, seed: Optional[int] = None):
        """One engine round for ``n <= slots`` members: pad them to a
        power-of-two slot bucket with copies of the last (ga.py:357-380),
        roll out on slots ``[0, bucket)``, drop the padding. The rollout
        seed is drawn unless given. Returns numpy (returns [n], lengths
        [n], bc [n, ...])."""
        seed = self._draw_seed() if seed is None else seed
        n = thetas.shape[0]
        B = self.env.batch_size
        nb = 1
        while nb < n:
            nb *= 2
        nb = min(nb, B)
        if n < nb:
            thetas = torch.cat([thetas, thetas[-1:].expand(nb - n, -1)])
        stats = self.model.batch_ref_stats(thetas, self.ref_batch) if self.model.needs_ref_batch else None
        res = rollout_host(
            self.env, self.model.make_batch_act(), (thetas, stats), seed, int(tslimit), self.device,
            n_slots=nb if nb < B else None,
        )
        return res.returns[:n], res.lengths[:n], res.bc[:n]

    def _eval_device(self, thetas: torch.Tensor, tslimit: int, seed: Optional[int] = None):
        """One device-env round: an episode of each of ``thetas [n, D]``,
        each from its own reset state (the JAX package's ``_eval_thetas``
        and a round of ``_ga_gen_rounds``); the rollout seed is drawn
        unless given. Returns (returns [n], lengths [n], bc [n, bc_dim]) on
        the device."""
        state = self._episode_starts(self._draw_seed() if seed is None else seed, thetas.shape[0])
        stats = self.model.batch_ref_stats(thetas, self.ref_batch) if self.model.needs_ref_batch else None
        res = rollout_batch(self.env, self.model.make_batch_act(), (thetas, stats), state, int(tslimit))
        return res.returns, res.lengths, res.bc

    def _eval(self, thetas: torch.Tensor, tslimit: int, seed: Optional[int] = None):
        args = (thetas, tslimit) if seed is None else (thetas, tslimit, seed)
        return self._eval_host(*args) if self.is_host_env else self._eval_device(*args)

    def _chunk(self, n: int) -> int:
        """Members a round evaluates: at most the θ budget's
        ``theta_hbm_budget // (4·D)``, and the engine's slots or, on a
        device env, ``eval_batch`` when it is set (ga.py:325, 431)."""
        cap = max(1, int(self.config.theta_hbm_budget) // (self.model.num_params * 4))
        return min(self.env.batch_size if self.is_host_env else self.config.eval_batch or n, cap, n)

    def _eval_chunked(self, thetas: torch.Tensor, tslimit: int, episodes_per: int = 1):
        """``episodes_per`` episodes of each of ``thetas [N, D]``, in rounds
        of ``_chunk`` episodes; repeats are gathered per round, never
        materialized as ``[N·episodes, D]``. Returns returns and lengths
        ``[N, episodes_per]`` and bc ``[N, episodes_per, ...]`` (numpy)."""
        N = thetas.shape[0]
        total = N * episodes_per
        idx_map = np.repeat(np.arange(N), episodes_per)
        chunk = self.env.batch_size if self.is_host_env else self._chunk(total)
        outs = []
        for s in range(0, total, chunk):
            part = thetas.index_select(0, torch.as_tensor(idx_map[s : s + chunk], device=self.device))
            outs.append(self._eval(part, tslimit))
        rets, lens, bcs = (_gather(x) for x in zip(*outs))
        return (rets.reshape(N, episodes_per), lens.reshape(N, episodes_per),
                bcs.reshape((N, episodes_per) + bcs.shape[1:]))

    def _fitness_pass(self, n: int, power: float, randomize: bool):
        """Make and evaluate ``n`` offspring, one episode each, in rounds of
        ``_chunk(n)`` members (ga.py:419-481). Returns numpy (pidx, midx,
        rewards, lengths, bcs), ``[n]`` each."""
        chunk = self._chunk(n)
        n_parents = 0 if randomize else len(self.cached_parent_seeds)
        outs = []
        for _ in range(-(-n // chunk)):
            pidx, midx = self._draw_offspring(chunk, n_parents)
            with record_function("ga.offspring"):
                thetas = self._offspring_thetas(pidx, midx, power, randomize)
            with record_function("ga.rollout"):
                outs.append((pidx, midx) + tuple(self._eval(thetas, self.cutoff.tslimit)))
            del thetas
        return tuple(_gather(x)[:n] for x in zip(*outs))

    # ----------------------------------------------------------- generation

    def train_step(self) -> GAState:
        cfg = self.config
        st = self.state
        tstart_iter = time.time()
        power = float(self.mutation_power.value(iteration=st.it, frames=st.timesteps_so_far))
        if cfg.genome_style == "cpu":  # bare-index chains mutate with one global stdev (es ga.py:262-263)
            power = cfg.noise_stdev
        n = cfg.population_size
        randomize = not self.cached_parent_seeds
        pidx, midx, rewards, lengths, bcs = self._fitness_pass(n, power, randomize)
        if randomize:
            chains = [(int(midx[i]),) for i in range(n)]
        elif cfg.genome_style == "gpu":
            chains = [self.cached_parent_seeds[pidx[i]] + ((int(midx[i]), power),) for i in range(n)]
        else:
            chains = [self.cached_parent_seeds[pidx[i]] + (int(midx[i]),) for i in range(n)]
        return self._selection_and_ladder(chains, rewards, lengths, bcs, power, tstart_iter)

    def _selection_and_ladder(self, chains, rewards, lengths, bcs, power, tstart_iter) -> GAState:
        """Truncation selection, the validation ladder, the elite test, the
        parent cache, counters and the tabular row (gpu ga.py:180-271)."""
        cfg = self.config
        st = self.state
        n = len(chains)
        population_timesteps = int(lengths.sum())
        results = [Offspring(chains[i], float(rewards[i]), int(lengths[i])) for i in range(n)]

        # elite carry-over at their recorded scores (es_distributed/ga.py:139-141)
        if cfg.num_elites > 0 and st.population:
            results = st.population[: cfg.num_elites] + results
            rewards = np.concatenate([[o.fitness for o in st.population[: cfg.num_elites]], rewards])

        order = np.argsort([-o.fitness for o in results], kind="stable")
        st.population = [results[i] for i in order][: max(cfg.population_size, 1)]

        # ---- validation ladder (gpu ga.py:189-204)
        validation_population = st.population[: cfg.validation_threshold]
        if st.elite is not None and cfg.validation_threshold > 0:
            if st.elite.seeds not in [o.seeds for o in validation_population]:
                validation_population = [st.elite] + validation_population[:-1]

        val_timesteps = 0
        with record_function("ga.ladder"):
            if cfg.validation_threshold > 0 and cfg.num_validation_episodes > 0:
                vthetas = torch.stack([self._lookup_theta(o.seeds) for o in validation_population])
                vrets, vlens, _ = self._eval_chunked(vthetas, self.cutoff.tslimit, cfg.num_validation_episodes)
                del vthetas
                population_validation = vrets.mean(axis=1)
                val_timesteps = int(vlens.sum())
                elite_idx = int(np.argmax(population_validation))
                st.elite = validation_population[elite_idx]
                # ---- elite test episodes, at the env's own cutoff
                etheta = self._lookup_theta(st.elite.seeds)[None]
                trets, tlens, tbcs = self._eval_chunked(etheta, self.env.default_timestep_cutoff,
                                                        cfg.num_test_episodes)
                elite_test_mean = float(trets.mean())
                if float(population_validation[elite_idx]) > st.curr_solution_val:
                    st.curr_solution = st.elite.seeds
                    st.curr_solution_val = float(population_validation[elite_idx])
                    st.curr_solution_test = elite_test_mean
            else:
                population_validation = np.array([])
                elite_idx = 0
                elite_test_mean = float("nan")
                st.elite = st.population[0]
                trets = np.zeros((0, 0))

        # ---- the next generation's parent cache (gpu ga.py:260-271)
        if cfg.selection_threshold > 0:
            parents = st.population[: cfg.selection_threshold]
            if st.elite is not None and st.elite.seeds not in [o.seeds for o in parents]:
                parents = [st.elite] + parents[: cfg.selection_threshold - 1]
            new_seeds = [o.seeds for o in parents]
            # resolved against the old cache before it is replaced: every new
            # parent is an old parent or an old parent plus one mutation
            new_thetas = torch.stack([self._lookup_theta(s) for s in new_seeds])
            self.cached_parent_seeds = new_seeds
            self.cached_parent_thetas = new_thetas
        else:
            self.cached_parent_seeds = []
            self.cached_parent_thetas = None

        # ---- counters, cutoff, logging
        st.it += 1
        timesteps_this_iter = population_timesteps + val_timesteps
        st.timesteps_so_far += timesteps_this_iter
        st.validation_timesteps_so_far += val_timesteps
        self.cutoff = update_cutoff(self.cutoff, lengths)
        dt = time.time() - tstart_iter
        st.time_elapsed += dt

        tlogger.record_tabular("Iteration", st.it)
        tlogger.record_tabular("MutationPower", power)
        tlogger.record_tabular("TimestepLimitPerEpisode", int(self.cutoff.tslimit))
        tlogger.record_tabular("PopulationEpRewMax", float(rewards.max()))
        tlogger.record_tabular("PopulationEpRewMean", float(rewards.mean()))
        tlogger.record_tabular("PopulationEpCount", int(rewards.size))
        tlogger.record_tabular("PopulationTimesteps", population_timesteps)
        tlogger.record_tabular("NumSelectedIndividuals", cfg.selection_threshold)
        if population_validation.size:
            tlogger.record_tabular(
                "TruncatedPopulationRewMean", float(np.mean([o.fitness for o in validation_population]))
            )
            tlogger.record_tabular("TruncatedPopulationValidationRewMean", float(np.mean(population_validation)))
            tlogger.record_tabular("TruncatedPopulationEliteValidationRewMean", float(np.max(population_validation)))
            tlogger.record_tabular("TruncatedPopulationEliteIndex", elite_idx)
            tlogger.record_tabular("TruncatedPopulationEliteTestRewMean", elite_test_mean)
            tlogger.record_tabular("TruncatedPopulationEliteTestEpCount", int(trets.size))
        tlogger.record_tabular("ValidationTimestepsThisIter", val_timesteps)
        tlogger.record_tabular("ValidationTimestepsSoFar", st.validation_timesteps_so_far)
        tlogger.record_tabular("TimestepsThisIter", timesteps_this_iter)
        tlogger.record_tabular("TimestepsPerSecondThisIter", timesteps_this_iter / max(dt, 1e-9))
        tlogger.record_tabular("TimestepsSoFar", st.timesteps_so_far)
        tlogger.record_tabular("TimeElapsedThisIter", dt)
        tlogger.record_tabular("TimeElapsed", st.time_elapsed)
        tlogger.dump_tabular()
        if cfg.vine_snapshot_dir and self.writes:  # ga_modified.py:22-64: GA has no pairs, so both columns are the offspring's
            midx = np.array([c[-1][0] if len(c) > 1 and isinstance(c[-1], tuple) else c[0] for c in chains])
            off = rewards[-n:]  # the offspring's rows, past the carried-over elites
            vine.master_extract_cloud(cfg.vine_snapshot_dir, st.it, np.stack([bcs, bcs], axis=1),
                                      np.stack([off, off], axis=1), np.stack([lengths, lengths], axis=1), midx,
                                      np.zeros(n, np.int64))
            if population_validation.size:
                vine.master_extract_parent(cfg.vine_snapshot_dir, st.it, tbcs[0], trets[0], tlens[0], float(power),
                                           model=self.model, theta=self._lookup_theta(st.elite.seeds),
                                           ref_batch=self.ref_batch)
        return st

    def train(self, max_iterations: int = 10**9) -> GAState:
        """Generations until ``state.it`` reaches ``max_iterations`` or the
        timestep budget is spent."""
        while self.state.it < max_iterations and self.state.timesteps_so_far < self.config.timesteps:
            self.train_step()
        return self.state

    def close(self) -> None:
        """Stop the host engine's threads (a device env holds none)."""
        if self.is_host_env:
            self.env.close()


def _gather(parts):
    """Round results (numpy, or tensors on the device) → one numpy array."""
    return torch.cat(parts).cpu().numpy() if torch.is_tensor(parts[0]) else np.concatenate(parts)


class RSTrainer(GATrainer):
    """Random search (es_distributed/rs.py): every candidate is a fresh
    single-index genome (rs.py:210-217, a GA without parents), and the best
    candidate ever seen is kept (rs.py:111-116)."""

    def __init__(self, env, model, config: GAConfig, **kw):
        super().__init__(env, model, dataclasses.replace(config, selection_threshold=0, num_elites=0), **kw)
        self.best_score = float("-inf")
        self.best_seeds: Optional[Tuple] = None

    def train_step(self) -> GAState:
        st = super().train_step()
        top = st.population[0]
        if top.fitness > self.best_score:
            self.best_score = top.fitness
            self.best_seeds = top.seeds
        return st
