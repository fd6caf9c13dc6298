"""Checkpoints: policy files that both packages read, and trainer snapshots
for resume.

The counterpart of the JAX package's utils/checkpoint.py (after the
reference's policy snapshots, policies.py:49-67 and es.py:345-353, and the
GPU stack's TrainingState pickle, gpu es.py:278-283, ga.py:134-155).

**Policy files** (``save_policy_snapshot`` / ``load_policy_snapshot``) are
exchangeable with the JAX package's in both directions. The payload is the
JAX package's dict of plain values:

* ``theta``: the flat θ as float32 numpy, in the layout both packages share
  (ops/flat.py);
* ``model_class`` and ``model_kwargs``: the class name and its constructor
  arguments under the JAX package's field names (the DQNs' ``in_hw``,
  ``in_ch``, ``out_std`` and ``nonlin_type`` among them). The port fixes a
  few of those fields per class (the DQNs' ``LAYERS`` and ``FC``, the
  VBN-DQN's ``scale_style``); it writes their values, and reads a file only
  where they equal its own. It ignores the JAX package's TPU-only knobs
  (``matvec_impl``, ``fused_interpret``);
* ``ob_stat``: a plain ``(sum, sumsq, count)`` tuple of numpy arrays;
* ``ref_batch`` (numpy) and ``extra`` (a dict).

A JAX file pickles the JAX package's ``RunningStat`` (and a JAX GA trainer
pickle its ``Offspring``, a JAX ES one its ``AdamState``/``SGDState``).
``load_pickle`` reads them with an unpickler that maps those names onto the
port's own classes, without importing the JAX package, and refuses every
other name of the JAX package or of jax.

**Trainer snapshots** (``save_trainer`` / ``load_trainer``) are the port's
own format: everything a generation reads (θ, the optimizer state, the obs
stats, the cutoff, the reference batch, the counters; the GA's population,
elite and parent cache; NS-ES's parents, archive and current parent) and the
state of the trainer's ``torch.Generator``, so that a resumed run's next
generation equals the uninterrupted one bit for bit wherever a reset with
its seed fixes the episode (the device envs; ToyCatch without EpisodicLife).
The host engine's own state is in no snapshot, so with EpisodicLife (the
``<Game>NoFrameskip-v4`` ids) a resumed run continues the counters and the
state but not the episodes. A JAX trainer snapshot holds a threefry key and
cannot resume a port trainer: ``load_trainer`` refuses it.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import models
from ..device import resolve_device
from ..ops import genome
from ..ops.obstat import RunningStat
from ..ops.optim import AdamState, SGDState

FORMAT = "deep_neuroevolution_torch.trainer/1"  # the port's trainer snapshots

# the JAX package's model fields that the port fixes per class (they keep
# their defaults in every JAX model too): field → the port class's attribute
_CONSTANT_ATTRS = {"LAYERS": "LAYERS", "FC": "FC"}
# fixed values of JAX fields that a port class lacks
_CONSTANT_VALUES = {"scale_style": "fan_in"}
# the JAX package's TPU-only knobs, written with their defaults, ignored on reading
_TPU_ONLY = {"matvec_impl": "auto", "fused_interpret": False}
_JAX_NAMES = ("deep_neuroevolution_tpu", "jax", "jaxlib")


# ------------------------------------------------------------------ pickles


def _mapped_classes() -> Dict[Tuple[str, str], type]:
    from ..algos.ga import Offspring

    return {
        ("deep_neuroevolution_tpu.ops.obstat", "RunningStat"): RunningStat,
        ("deep_neuroevolution_tpu.ops.optim", "AdamState"): AdamState,
        ("deep_neuroevolution_tpu.ops.optim", "SGDState"): SGDState,
        ("deep_neuroevolution_tpu.algos.ga", "Offspring"): Offspring,
    }


class _Unpickler(pickle.Unpickler):
    """Maps the JAX package's RunningStat, AdamState, SGDState and Offspring
    onto the port's classes; refuses any other name of the JAX package or
    of jax (which the port cannot import)."""

    def find_class(self, module: str, name: str):
        mapped = _mapped_classes().get((module, name))
        if mapped is not None:
            return mapped
        if module.split(".")[0] in _JAX_NAMES:
            raise pickle.UnpicklingError(
                f"{module}.{name}: a class of the JAX package that the port does not read (it reads its "
                "RunningStat, AdamState, SGDState and Offspring)")
        return super().find_class(module, name)


def load_pickle(path: str):
    """A pickle of either package, the JAX package's classes mapped as
    ``_Unpickler`` says."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _dump(path: str, obj) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _host(x):
    """Tensors → numpy arrays, through NamedTuples, lists, tuples and dicts."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _device(x, device: torch.device):
    """numpy arrays → tensors on ``device``, through NamedTuples (the inverse
    of ``_host`` for the state fields that live on the device)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x)).to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_device(v, device) for v in x))
    return x


# ------------------------------------------------------------ policy files


def model_kwargs(model) -> Dict[str, Any]:
    """The JAX package's constructor arguments for the port's ``model``:
    its fields, plus the fields the port fixes, at the port's values."""
    kw = dataclasses.asdict(model)
    if hasattr(type(model), "LAYERS"):  # the DQN family
        kw.update({field: getattr(type(model), attr) for field, attr in _CONSTANT_ATTRS.items()})
        for field, value in {**_CONSTANT_VALUES, **_TPU_ONLY}.items():
            kw.setdefault(field, value)
    return kw


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def model_from(class_name: str, kwargs: Dict[str, Any]):
    """The port's model for a policy file's ``model_class`` and
    ``model_kwargs`` (the JAX package's names). A field the port fixes must
    hold the port's value; a TPU-only knob is ignored."""
    cls = getattr(models, class_name, None)
    if not (isinstance(cls, type) and issubclass(cls, models.Model)):
        cls = models.get_model(class_name)
    fields = {f.name for f in dataclasses.fields(cls)}
    own = {}
    for k, v in kwargs.items():
        v = _tuples(v)
        if k in fields:
            own[k] = v
        elif k in _TPU_ONLY:
            continue
        elif (k in _CONSTANT_ATTRS and hasattr(cls, _CONSTANT_ATTRS[k])) or k in _CONSTANT_VALUES:
            want = getattr(cls, _CONSTANT_ATTRS[k]) if k in _CONSTANT_ATTRS else _CONSTANT_VALUES[k]
            if v != want:
                raise NotImplementedError(
                    f"{class_name}: {k}={v!r} is not ported; the port fixes {k} = {want!r} per class")
        else:
            raise NotImplementedError(f"{class_name}: field {k!r} is not ported")
    return cls(**own)


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_policy_snapshot(path: str, model, theta, ob_stat=None, ref_batch=None,
                         extra: Optional[Dict[str, Any]] = None) -> None:
    """A policy file both packages read (the h5 snapshot's counterpart,
    policies.py:49-59): plain values only, see the module docstring."""
    _dump(path, {
        "theta": to_numpy(theta).astype(np.float32),
        "model_class": type(model).__name__,
        "model_kwargs": model_kwargs(model),
        "ob_stat": None if ob_stat is None else tuple(to_numpy(v) for v in ob_stat),
        "ref_batch": None if ref_batch is None else to_numpy(ref_batch),
        "extra": dict(extra or {}),
    })


def load_policy_snapshot(path: str, device=None):
    """A policy file of either package → ``(model, θ, payload)``: θ a float32
    tensor on ``device`` (default cuda); in ``payload``, ``ob_stat`` is the
    port's ``RunningStat`` of tensors and ``ref_batch`` a tensor, on
    ``device`` (or None)."""
    dev = resolve_device(device)
    payload = load_pickle(path)
    model = model_from(payload["model_class"], payload["model_kwargs"])
    theta = torch.from_numpy(np.array(payload["theta"], np.float32)).to(dev)
    if payload.get("ob_stat") is not None:
        payload["ob_stat"] = RunningStat(*(torch.from_numpy(np.array(v, np.float32)).to(dev)
                                           for v in payload["ob_stat"]))
    if payload.get("ref_batch") is not None:
        payload["ref_batch"] = torch.from_numpy(np.array(payload["ref_batch"], np.float32)).to(dev)
    return model, theta, payload


def theta_from_seed_chain(model, noise_table, seeds, genome_style: str = "gpu", noise_stdev: float = 0.002):
    """Flat θ of a seed chain, on the source's device (SURVEY §3.4); the
    source is a ``NoiseTable`` or a ``VirtualNoise``:
    GPU-style ``[init_idx, (idx, power), ...]`` (base.py:139-145), bit for
    bit the JAX package's, a bare index after the first adding nothing
    (power 0) as there; or CPU-style bare indices
    (es_distributed/ga.py:250-264): ``reinit_theta`` of the first row, then
    ``noise_stdev``·ε of each later one, rounded as the JAX package's eager
    loop rounds it (ops/genome.py ``reconstruct_cpu_style``)."""
    if genome_style not in ("gpu", "cpu"):
        raise ValueError(f"unknown genome_style {genome_style!r} (gpu|cpu)")
    dim = model.num_params
    if noise_table.size <= dim:
        raise ValueError(f"noise table ({noise_table.size}) must exceed num_params ({dim})")
    if genome_style == "cpu":
        return genome.reconstruct_cpu_style(noise_table, seeds, dim, model.reinit_theta, noise_stdev)
    idxs = torch.tensor([int(s[0]) if isinstance(s, (tuple, list)) else int(s) for s in seeds], dtype=torch.int64)
    powers = torch.tensor([float(s[1]) if isinstance(s, (tuple, list)) else 0.0 for s in seeds], dtype=torch.float32)
    scale_by = model.scale_by(getattr(model, "scale_style", "fan_in"), noise_table.device)
    return genome.reconstruct_gpu_style(noise_table, idxs, powers, dim, scale_by)


def initialize_from(small_snapshot_path: str, big_model, base_theta: torch.Tensor) -> torch.Tensor:
    """Warm-start surgery (policies.py:219-249): a smaller policy file's
    tensors go into the prefix slices of ``big_model``'s tensors of the
    same names; the rest keeps ``base_theta``. The JAX package starts from
    its own init at key 0; the port's callers pass the trainer's θ."""
    from ..ops import flat

    small_model, small_theta, _ = load_policy_snapshot(small_snapshot_path, device="cpu")
    small_parts = flat.unflatten(small_theta, small_model.specs)
    return flat.partial_load(base_theta, big_model.specs, small_parts)


def save_policy_snapshot_auto(log_dir: str, trainer, iteration: int, rew=None) -> Optional[str]:
    """The reference's periodic ``snapshot_iterNNNNN_rewR`` policy file
    (es.py:345-353; GA/RS ga.py:197-206): ES saves θ, NS-ES the current
    parent, GA/RS the elite rebuilt from its chain (and its fitness as the
    reward when none is given). Returns the path, or None when a GA has no
    elite yet."""
    from ..algos.es import ESTrainer
    from ..algos.ga import GATrainer
    from ..algos.nses import NSESTrainer

    ob_stat = None
    if isinstance(trainer, NSESTrainer):
        parent = trainer.parents[trainer.curr_parent]
        theta, ob_stat = parent.theta, parent.ob_stat
    elif isinstance(trainer, ESTrainer):
        theta, ob_stat = trainer.theta, trainer.ob_stat
    elif isinstance(trainer, GATrainer):
        elite = trainer.state.elite
        if elite is None:
            return None
        theta = trainer._lookup_theta(elite.seeds)
        rew = elite.fitness if rew is None else rew
    else:
        raise TypeError(type(trainer))
    if not trainer.model.needs_ob_stat:
        ob_stat = None
    rew_str = "NaN" if rew is None or not math.isfinite(rew) else str(int(np.round(rew)))
    path = str(Path(log_dir) / f"snapshot_iter{iteration:05d}_rew{rew_str}.pkl")
    save_policy_snapshot(path, trainer.model, theta, ob_stat=ob_stat, ref_batch=trainer.ref_batch,
                         extra={"env_id": getattr(trainer.env, "env_id", None), "iteration": iteration})
    return path


# --------------------------------------------------------- trainer snapshots


def trainer_type(trainer) -> str:
    """The snapshot's trainer type: the single-device trainer's class name
    (ESTrainer, NSESTrainer, GATrainer, RSTrainer), a pod trainer's too, so
    a pod's snapshot resumes in the single trainer and back."""
    algos = __name__.rsplit(".", 2)[0] + ".algos."
    return next(c.__name__ for c in type(trainer).__mro__ if c.__module__.startswith(algos))


def save_trainer(path: str, trainer) -> None:
    """The port's trainer snapshot of an ES, NS-ES, GA or RS trainer (see
    the module docstring)."""
    from ..algos.es import ESTrainer
    from ..algos.ga import GATrainer, RSTrainer
    from ..algos.nses import NSESTrainer

    state: Dict[str, Any] = {
        "format": FORMAT,
        "type": trainer_type(trainer),
        "cutoff": trainer.cutoff._asdict(),
        "ref_batch": _host(trainer.ref_batch),
        "generator": trainer.gen.get_state().numpy(),
    }
    if isinstance(trainer, ESTrainer):
        state["es"] = dict(
            theta=_host(trainer.theta), opt_state=_host(trainer.opt_state), ob_stat=_host(trainer.ob_stat),
            iteration=trainer.iteration, episodes_so_far=trainer.episodes_so_far,
            timesteps_so_far=trainer.timesteps_so_far, mean_len_est=trainer._mean_len_est,
        )
        if isinstance(trainer, NSESTrainer):
            state["nses"] = dict(
                parents=_host(trainer.parents), archive=_host(tuple(trainer.archive)),
                host_archive=list(trainer.host_archive), curr_parent=trainer.curr_parent,
            )
    elif isinstance(trainer, GATrainer):
        st = trainer.state
        state["ga"] = {k: getattr(st, k) for k in vars(st)}
        state["cached_parent_seeds"] = list(trainer.cached_parent_seeds)
        state["cached_parent_thetas"] = _host(trainer.cached_parent_thetas)
        if isinstance(trainer, RSTrainer):
            state["rs"] = dict(best_score=trainer.best_score, best_seeds=trainer.best_seeds)
    else:
        raise TypeError(type(trainer))
    _dump(path, state)


def load_trainer(path: str, trainer) -> None:
    """Restores a freshly built trainer of the snapshot's type in place; the
    generator's state is restored last, after everything the constructor
    drew. Refuses the JAX package's trainer snapshots."""
    from ..algos.es import CutoffState, ESTrainer
    from ..algos.ga import GATrainer, RSTrainer
    from ..algos.nses import NSESTrainer
    from ..ops import novelty

    state = load_pickle(path)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(
            f"{path} is not a trainer snapshot of the port (the JAX package's hold a threefry key and its own "
            "trainer state): policy files (save_policy_snapshot) and GA populations (load_population, "
            "GATrainer.copy_population) transfer between the packages; trainer states do not")
    if state["type"] != trainer_type(trainer):
        raise ValueError(f"{path} holds a {state['type']}, not a {trainer_type(trainer)}")
    dev = trainer.device
    trainer.cutoff = CutoffState(**state["cutoff"])
    trainer.ref_batch = _device(state["ref_batch"], dev)
    if isinstance(trainer, ESTrainer):
        es = state["es"]
        trainer.theta, trainer.opt_state, trainer.ob_stat = (_device(es[k], dev)
                                                             for k in ("theta", "opt_state", "ob_stat"))
        trainer.iteration, trainer.episodes_so_far, trainer.timesteps_so_far = (
            es["iteration"], es["episodes_so_far"], es["timesteps_so_far"])
        trainer._mean_len_est = es["mean_len_est"]
        if isinstance(trainer, NSESTrainer):
            ns = state["nses"]
            trainer.parents = [_device(p, dev) for p in ns["parents"]]
            trainer.archive = novelty.Archive(*(_device(v, dev) for v in ns["archive"]))
            trainer.host_archive = list(ns["host_archive"])
            trainer.curr_parent = ns["curr_parent"]
    elif isinstance(trainer, GATrainer):
        for k, v in state["ga"].items():
            setattr(trainer.state, k, v)
        trainer.cached_parent_seeds = list(state["cached_parent_seeds"])
        trainer.cached_parent_thetas = _device(state["cached_parent_thetas"], dev)
        if isinstance(trainer, RSTrainer):
            trainer.best_score, trainer.best_seeds = state["rs"]["best_score"], state["rs"]["best_seeds"]
    trainer.gen.set_state(torch.from_numpy(np.array(state["generator"])))
