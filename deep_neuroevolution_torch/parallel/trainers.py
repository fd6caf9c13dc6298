"""Device pods: the scale-out path of ``main train`` on device envs.

The counterpart of the JAX package's parallel/trainers.py. It replaces the
reference's fleet orchestration (the master consuming Redis results until
the quotas hold, es_distributed/es.py:230-265; the relay tree, dist.py:
124-138; per-machine worker forking, main.py:74-86): one process per card
runs the same program, a round's rows are split over the ranks, the
fitness columns are gathered, the gradient and obs-stat moments are summed,
and every rank applies the same update, so θ is never sent (the reference
already sent seeds, not weights, es.py:430).

The pod trainers subclass the single-device trainers and override only the
dispatch: how a round's rows are split over the ranks and how the columns
and sums come back (parallel/es_pod.py, ga_pod.py, nses_pod.py). Quota
accounting, the adaptive cutoff, the GA's selection and ladder, NS-ES's
archive and parent selection, snapshots and the metrics are inherited. Only
rank 0 writes VINE dumps (``writes``); ``main train`` gates the rest.

As in the JAX package (trainers.py:48-57), a device pod refuses a host
engine env, which scales through the host pods (parallel/host_pod.py), and
a ``VirtualNoise``, whose regenerated rows K2 cannot read.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from ..algos.es import ESTrainer
from ..algos.ga import GATrainer, RSTrainer
from ..algos.nses import NSESTrainer
from ..device import resolve_device
from ..ops.noise import VirtualNoise
from . import es_pod, ga_pod, nses_pod
from .mesh import pop_group


class _PodBase:
    """The pod of a trainer: its ranks (``self.pod``) and rank p's engine."""

    def _init_pod(self, device, emulate_procs: Optional[int]) -> None:
        self.pod = pop_group(resolve_device(device), emulate_procs)
        self.writes = self.pod.writes

    def _on_rank(self, p: int):
        """The context in which rank p's block runs (a device env has no
        per-rank state)."""
        return contextlib.nullcontext()


class _DevicePod(_PodBase):
    def _check_device_pod(self, env, noise_table) -> None:
        if getattr(env, "is_host_env", False):
            raise NotImplementedError(
                "device pods drive device envs; a host-engine env scales through the host pods "
                "(parallel/host_pod.py: one engine pool per rank; the loader's 'host_pod' override)")
        if isinstance(noise_table, VirtualNoise):
            raise ValueError("VirtualNoise is wired for the single-device trainers: a device pod's gradient (K2) "
                             "reads the shared table; run with overrides {'pod': false}")

    def _noise_gradient(self, idxs, w):
        """Each rank's partial sum over its own rows, added across ranks."""
        return es_pod.partial_gradient(self, idxs, w, super()._noise_gradient)


class PodESTrainer(_DevicePod, ESTrainer):
    """ES on a device env over the pod: a generation's rounds (fixed
    population or quota mode) split over the ranks, the update from the
    gathered columns and summed partial gradients, the eval episodes
    split."""

    def __init__(self, env, model, config, optimizer=None, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._check_device_pod(env, noise_table)
        super().__init__(env, model, config, optimizer=optimizer, noise_table=noise_table, seed=seed, device=device)
        self._init_pod(self.device, emulate_procs)

    def _npairs_round(self) -> int:
        return es_pod.npairs_per_rank(self)

    def _device_rounds(self, npairs, obstat_prob):
        return es_pod.device_rounds(self, npairs, obstat_prob)

    def _device_eval(self, seed, rows=None):
        return es_pod.eval_split(self, seed, super()._device_eval)


class PodGATrainer(_DevicePod, GATrainer):
    """The GA on a device env over the pod: the fitness pass split over
    the ranks (parallel/ga_pod.py); selection, the ladder (every rank runs
    it whole, as in the JAX package) and the parent cache are the single
    trainer's, the same on every rank."""

    def __init__(self, env, model, config, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._check_device_pod(env, noise_table)
        super().__init__(env, model, config, noise_table=noise_table, seed=seed, device=device)
        self._init_pod(self.device, emulate_procs)

    def _fitness_pass(self, n: int, power: float, randomize: bool):
        return ga_pod.fitness_pass(self, n, power, randomize)


class PodRSTrainer(PodGATrainer, RSTrainer):
    """Random search on a device env over the pod (RSTrainer's rules)."""


class PodNSESTrainer(_DevicePod, NSESTrainer):
    """NS-ES and NSR-ES on a device env over the pod: the antithetic rounds
    and their novelty split over the ranks (parallel/nses_pod.py), the
    update from the gathered columns and summed partial gradients; the
    archive and the parents' mean BCs are computed alike on every rank."""

    def __init__(self, env, model, config, optimizer=None, noise_table=None, seed: int = 0, device=None,
                 emulate_procs: Optional[int] = None):
        self._check_device_pod(env, noise_table)
        super().__init__(env, model, config, optimizer=optimizer, noise_table=noise_table, seed=seed, device=device)
        self._init_pod(self.device, emulate_procs)

    def _npairs_round(self) -> int:
        return nses_pod.blocks(self)[0]

    def _perturbed_eval(self, npairs: int, draws=None):
        return nses_pod.perturbed_eval(self, super()._perturbed_eval)
