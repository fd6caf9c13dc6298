"""Experiment configuration: the GPU-stack schema, and the CPU-stack schema's
ES, GA, RS and NS-ES branches.

The counterpart of the JAX package's utils/config.py. Two schemas:

* GPU stack (gpu_implementation/configurations/*.json), flat: "game",
  "model", "population_size", "episode_cutoff_mode", "mutation_power",
  "l2coeff", "return_proc_mode", "optimizer", and the GA's
  "selection_threshold", "validation_threshold", "num_validation_episodes",
  "num_test_episodes", "timesteps". The algorithm is ``algo`` if given,
  else GA when the file has "selection_threshold" and ES otherwise
  (config.py:213, 247-261 of the JAX package); ``"rs"`` runs random search
  on a GA file.
* CPU stack (es_distributed): {"config": {...}, "env_id", "policy":
  {"type", "args"}, "optimizer", "population_size"} (config.py:264-313 of
  the JAX package). ``algo`` "ga" or "rs" runs the GA or random search on
  CPU-style genomes (:314-329): bare-index chains mutated with the file's
  ``noise_stdev``, the file's ``population_size`` (1000),
  ``selection_threshold`` (20) and ``num_elites`` (1), no validation or
  test episodes unless the file asks for them (``frostbite_ga.json``).
  ES runs in quota mode when ``episodes_per_batch`` or
  ``timesteps_per_batch`` is set (``frostbite_es.json``). ``eval_prob``
  sets the eval-episode count as there: ``eval_prob · episodes_per_batch``
  (the file's, at least 1) when both are set, else 8. A file with
  "novelty_search" (or ``algo`` "nses") runs NS-ES, as the
  JAX package's config.py:330-361 reads it: the population is
  ``episodes_per_batch`` (``timesteps_per_batch`` is not read),
  ``algo_type``, k, M, ``num_rollouts``, ``selection_method`` and
  ``calc_obstat_prob`` (which the JAX package's loader leaves out, so its
  NS-ES never samples obs stats) come from the file, ``bc_mode`` is 'traj' on the Atari engine and 'final'
  elsewhere (the MuJoCo engine's BC is its own ``bc_mode``'s), and no eval episodes run.

``resolve_env`` maps env ids onto the registry (envs/core.py ``make``):
'maze', 'gym.<Id>' and 'CartPole-*' are device envs; the MuJoCo families
(envs/mujoco.py ``MUJOCO_FAMILIES``: Humanoid-v1 and the like, through
``resolve_env_id`` onto gymnasium's versions) run on the MuJoCo host
engine, ``HumanoidTrap`` on the humanoid in ``deceptive_humanoid_xml``'s
trap world (the JAX package's config.py:60-74); they need gymnasium and
mujoco, and raise without them. Any other game runs on the Atari host
engine: ToyCatch for 'toy' (the engine's own 64 slots unless
``env_kwargs`` says otherwise, as the JAX package's config.py:54-55 makes
it), an ALE game where the engine was built with ALE (256 slots unless
``env_kwargs`` says otherwise).
``<Game>NoFrameskip-v4`` ids run that game with EpisodicLife on, on
ToyCatch where the engine has no ALE, as the JAX package runs them (its
config.py:34-53). An experiment's own ``env_kwargs`` (``humanoid_nses.json``'s
``bc_mode``) reach the env, patched by the overrides' (its config.py:185-
187).

Experiment keys the JAX package acts on, acted on where it reads them:

* ``load_from`` (GPU-stack ES, the GA-seeded ES): θ₀ from the pickled seed
  chain at that path, after ``.format(**exp)`` (its config.py:233-245);
* ``load_population`` (GPU-stack GA and RS): ``GATrainer.copy_population``
  of that file, either package's trainer snapshot or a list of chains
  (:260-261);
* ``mirror_crn`` (ES: a GPU-stack file's top level, a CPU-stack file's
  "config"): mirrored pairs on the host engine;
* the policy's ``init_from`` (CPU-stack ES): the warm start from a smaller
  policy file of either package (:302-311, ops/flat.py ``partial_load``).

Each is refused with ``NotImplementedError`` where the JAX package does not
read it (so it is never dropped without a word).

``overrides`` patches a run without editing the file:

* ``game`` — the env to run instead of the file's game (GPU schema). The
  default engine has no ALE, so an Atari experiment runs on ``"toy"``;
* ``population_size`` and ``episode_cutoff_mode`` — the file's fields;
* ``env_kwargs`` — keyword arguments of the env: for the host engines
  ``batch_size`` (slots) and ``num_threads``, for the Atari one
  ``pipeline_groups`` and ``obs_mode``, for the MuJoCo one ``bc_mode`` and
  ``traj_len``;
* ``noise_size`` — noise-table length (default 250M, the reference's);
* ``noise`` — the noise source instead of the reference's host-built
  ``RandomState(123)`` table (the JAX package's config.py:189-208):
  ``"virtual"``, a ``VirtualNoise`` of ``PRNGKey(123)`` with ``noise_size``
  ids (no table; rows regenerated where read, and ES's gradient without
  K2), or ``"device"``, ``NoiseTable.from_key(PRNGKey(noise_seed))`` built
  on the device. Any other value raises;
* ``noise_seed`` — the ``"device"`` table's key seed (default 123);
* ``theta_hbm_budget`` — bytes allowed for one round's θ batch;
* ``eval_batch`` — ES: pairs a round; GA and RS: members a round on a
  device env (the engine's slots bound a host-engine round);
* ES only: ``num_eval_episodes`` (noiseless episodes of θ per
  generation), ``grad_chunk`` (pairs the gradient's plain version gathers
  at a time), ``mirror_crn``; CPU-stack ES only: ``episodes_per_batch``
  and ``timesteps_per_batch`` (the quotas);
* ``bc_mode`` — NS-ES only: 'final' or 'traj';
* ``pod`` — device envs: ``"auto"`` (the default), ``true`` or ``false``;
  ``host_pod`` — host-engine envs: N ranks emulated in this process
  (below).

Scale-out (the JAX package's config.py:141-183, parallel/): a device env
in a ``torch.distributed`` world of more than one rank, or with ``pod:
true``, gets a device pod (parallel/trainers.py: ``PodESTrainer``,
``PodGATrainer``, ``PodRSTrainer``, ``PodNSESTrainer``); ``pod: "auto"``
with ``noise: "virtual"`` stays single, and ``pod: false`` always does. A
host-engine env in a world of more than one rank gets a host pod
(parallel/host_pod.py: ``HostPod*Trainer``), one engine pool a rank;
``host_pod: N`` runs N ranks' blocks one after the other in this process
(``emulate_procs``). ``pod`` on a host-engine env and ``host_pod`` on a
device env are refused, as is a device pod on ``noise: virtual``.

A DQN policy's ``nonlin_type`` and ``ac_init_std`` reach the model as its
``nonlin_type`` and ``out_std`` (the JAX package's config.py:113-116); a
MujocoPolicy is sized from its env (obs and action widths, the action
bounds).

Rejected with ``NotImplementedError``: NS-ES on a GPU-stack file, which
the JAX package does not run either.
"""

from __future__ import annotations

import functools
import re
from typing import Any, Dict, Optional

import numpy as np

from .. import envs, models
from ..algos.es import ESConfig, ESTrainer
from ..algos.ga import GAConfig, GATrainer, RSTrainer
from ..algos.nses import NSESConfig, NSESTrainer
from ..device import resolve_device
from ..envs import atari, mujoco
from ..envs.core import Continuous, Discrete
from ..ops import optim
from ..ops.noise import DEFAULT_COUNT, NoiseTable, VirtualNoise, prng_key
from . import checkpoint

_OVERRIDES = {
    "game", "population_size", "episode_cutoff_mode", "env_kwargs", "noise_size", "theta_hbm_budget",
    "num_eval_episodes", "bc_mode", "eval_batch", "grad_chunk", "mirror_crn", "episodes_per_batch",
    "timesteps_per_batch", "noise", "noise_seed", "pod", "host_pod",
}
_NOISE_SOURCES = ("virtual", "device")
_ES_OVERRIDES = ("num_eval_episodes", "grad_chunk", "mirror_crn")
_QUOTA_OVERRIDES = ("episodes_per_batch", "timesteps_per_batch")
# experiment keys the JAX package acts on, and the (schema, algo) runs that
# read them (its utils/config.py:222, 233-245, 260-261, 292)
_KEYS_READ = {
    "load_population": ({("gpu", "ga"), ("gpu", "rs")}, "a GPU-stack GA or RS experiment"),
    "load_from": ({("gpu", "es")}, "a GPU-stack ES experiment"),
    "mirror_crn": ({("gpu", "es"), ("cpu", "es")}, "ES (a GPU-stack file's top level, a CPU-stack file's 'config')"),
}
def resolve_env(env_id: str, **kwargs):
    """An env id of either schema → a device env or a host engine."""
    m = re.fullmatch(r"([A-Za-z0-9]+)NoFrameskip-v\d+", env_id)
    if m:
        # the CPU stack wraps its training envs with wrap_deepmind, whose
        # EpisodicLifeEnv is on by default (atari_wrappers.py:204-222);
        # without ALE in the engine, ToyCatch stands in for the game
        game = re.sub(r"(?<!^)(?=[A-Z])", "_", m.group(1)).lower()
        game = game if atari.is_available() else "toy"
        return envs.make(game, **{"batch_size": 256, "episodic_life": True, **kwargs})
    if env_id.split("-")[0] == "CartPole":
        env_id = "gym." + env_id
    if env_id in ("maze", "toy") or env_id.startswith("gym."):
        return envs.make(env_id, **kwargs)
    family = env_id.split("-")[0]
    if family in mujoco.MUJOCO_FAMILIES:
        if not mujoco.is_available():
            raise RuntimeError(f"env id {env_id!r} needs gymnasium and mujoco, which do not import here")
        if family == "HumanoidTrap":  # NS-ES's deceptive world
            return mujoco.MujocoHostEnv(mujoco.resolve_env_id("Humanoid-v5"), xml_file=mujoco.deceptive_humanoid_xml(),
                                        **kwargs)
        return mujoco.MujocoHostEnv(mujoco.resolve_env_id(env_id), **kwargs)
    return envs.make(env_id, **{"batch_size": 256, **kwargs})  # the JAX package's Atari default


def build_model(policy_type: str, args: Dict[str, Any], env) -> models.Model:
    """A model for ``env`` from a reference policy or model name; the
    policy's ``init_from`` is the trainer's business, not the model's."""
    args = {k: v for k, v in args.items() if k != "init_from"}
    cls = models.get_model(policy_type)
    space = getattr(env, "action_space", None)
    if cls in (models.MujocoMLP, models.ContinuousMLP):
        if not isinstance(space, Continuous):
            raise ValueError(f"{policy_type} needs a continuous action space, got {space}")
        if cls is models.ContinuousMLP:
            return cls(obs_dim=env.obs_shape[0], ac_dim=space.dim, **args)
        return cls(
            obs_dim=env.obs_shape[0],
            ac_dim=space.dim,
            ac_low=tuple(space.low) if space.low else (-1.0,) * space.dim,
            ac_high=tuple(space.high) if space.high else (1.0,) * space.dim,
            **{k: (tuple(v) if k == "hidden_dims" else v) for k, v in args.items()},
        )
    num_actions = space.n if isinstance(space, Discrete) else env.num_actions
    kwargs = {k: args[k] for k in ("nonlin_type",) if k in args}
    if "ac_init_std" in args:  # GAAtariPolicy's out-layer std (policies.py:436)
        kwargs["out_std"] = args["ac_init_std"]
    if "obs_dim" in getattr(cls, "__dataclass_fields__", {}):
        return cls(obs_dim=int(np.prod(env.obs_shape)), num_actions=num_actions, **kwargs)
    return cls(num_actions=num_actions, **kwargs)


def _pick(ctor, env, overrides: Dict[str, Any]):
    """The single trainer ``ctor`` or its pod (the JAX package's
    ``pick_trainer``, config.py:141-183)."""
    from ..parallel import distributed

    world = distributed.process_count()
    if getattr(env, "is_host_env", False):
        if "pod" in overrides:
            raise ValueError("the 'pod' override applies to device envs; a host-engine env scales by 'host_pod' "
                             "or by the ranks of a torch.distributed world")
        emulate = overrides.get("host_pod")
        if emulate is not None and (isinstance(emulate, bool) or int(emulate) < 1):
            raise ValueError(f"'host_pod' takes a rank count of at least 1, not {emulate!r}")
        if not emulate and world <= 1:
            return ctor
        from ..parallel import host_pod as hp

        pod_ctor = {ESTrainer: hp.HostPodESTrainer, GATrainer: hp.HostPodGATrainer, RSTrainer: hp.HostPodRSTrainer,
                    NSESTrainer: hp.HostPodNSESTrainer}[ctor]
        return functools.partial(pod_ctor, emulate_procs=int(emulate)) if emulate else pod_ctor
    if "host_pod" in overrides:
        raise ValueError("the 'host_pod' override applies to host-engine envs; a device env scales by 'pod'")
    pod = overrides.get("pod", "auto")
    if pod not in ("auto", True, False):
        raise ValueError(f"the 'pod' override takes \"auto\", true or false, not {pod!r}")
    if pod == "auto" and overrides.get("noise") == "virtual":
        pod = False  # VirtualNoise is wired for the single-device trainers
    if not (pod is True or (pod == "auto" and world > 1)):
        return ctor
    from ..parallel import trainers as pt

    return {ESTrainer: pt.PodESTrainer, GATrainer: pt.PodGATrainer, RSTrainer: pt.PodRSTrainer,
            NSESTrainer: pt.PodNSESTrainer}[ctor]


def default_eval_episodes(cfg: Dict[str, Any]) -> int:
    """The CPU stack's eval_prob as a fixed eval-episode count (the JAX
    package's config.py:272-278)."""
    eval_prob, epb = cfg.get("eval_prob", 0.0), int(cfg.get("episodes_per_batch", 0))
    return max(1, int(eval_prob * epb)) if eval_prob > 0 and epb else 8


def load_experiment(
    exp: Dict[str, Any],
    seed: int = 0,
    overrides: Optional[Dict[str, Any]] = None,
    device=None,
    algo: Optional[str] = None,
    noise_table: Optional[NoiseTable] = None,
):
    """Experiment dict → ready ES, GA, RS or NS-ES trainer, or its pod, on
    ``device`` (default cuda; a torchrun rank's own card). ``noise_table``, when given, is used instead of building one
    (so a process that runs several experiments builds it once)."""
    overrides = dict(overrides or {})
    unknown = set(overrides) - _OVERRIDES
    if unknown:
        raise ValueError(f"unsupported overrides {sorted(unknown)}; supported: {sorted(_OVERRIDES)}")
    cpu_schema = "game" not in exp
    if cpu_schema:
        if "env_id" not in exp:
            raise ValueError("an experiment needs a 'game' (GPU-stack schema) or an 'env_id' (CPU-stack schema)")
        algo = algo or exp.get("algo") or ("nses" if "novelty_search" in exp else "es")
    else:
        algo = algo or ("ga" if "selection_threshold" in exp else "es")
    run = ("cpu" if cpu_schema else "gpu", algo)
    for key, (runs, where) in _KEYS_READ.items():
        block = exp.get("config", {}) if cpu_schema and key == "mirror_crn" else exp
        if (key in exp or key in exp.get("config", {})) and not (run in runs and key in block):
            raise NotImplementedError(f"experiment key {key!r} is not ported yet for this run ({algo}): "
                                      f"the JAX package reads it only in {where}")
    if "init_from" in exp.get("policy", {}).get("args", {}) and run != ("cpu", "es"):
        raise NotImplementedError("the policy's 'init_from' warm start is not ported yet for this run "
                                  f"({algo}): the JAX package reads it only in a CPU-stack ES experiment")
    if algo == "nses" and not cpu_schema:
        raise NotImplementedError("algo 'nses': NS-ES runs CPU-stack files (with 'novelty_search'), not GPU-stack ones")
    ported = ("es", "ga", "rs", "nses") if cpu_schema else ("es", "ga", "rs")
    if algo not in ported:
        raise NotImplementedError(f"algo {algo!r} is not ported yet for this schema; ported: {', '.join(ported)}")
    if "eval_batch" in overrides and algo == "nses":
        raise ValueError("the 'eval_batch' override applies to ES, GA and RS only")
    for key in _ES_OVERRIDES:
        if key in overrides and algo != "es":
            raise ValueError(f"the {key!r} override applies to ES only")
    for key in _QUOTA_OVERRIDES:
        if key in overrides and run != ("cpu", "es"):
            raise ValueError(f"the {key!r} override applies to CPU-stack ES only (quota mode)")
    if "bc_mode" in overrides and algo != "nses":
        raise ValueError("the 'bc_mode' override applies to NS-ES only")
    device = resolve_device(device)
    budget = {k: overrides[k] for k in ("theta_hbm_budget",) if k in overrides}
    ga_knobs = {**budget, **{k: int(overrides[k]) for k in ("eval_batch",) if k in overrides}}
    noise_table = _noise_source(overrides, device, noise_table)

    if cpu_schema:
        env_id, model_name, model_args = exp["env_id"], exp["policy"]["type"], exp["policy"].get("args", {})
    else:
        exp = {**exp, **{k: overrides[k] for k in ("game", "population_size", "episode_cutoff_mode") if k in overrides}}
        env_id, model_name, model_args = exp["game"], exp["model"], {}
    env = resolve_env(env_id, **{**exp.get("env_kwargs", {}), **overrides.get("env_kwargs", {})})
    try:
        model = build_model(model_name, model_args, env)
        if algo == "nses":
            return _nses_trainer(env, model, exp, overrides, budget, noise_table, seed, device)
        if cpu_schema and algo in ("ga", "rs"):
            c = exp["config"]
            cfg = GAConfig(  # the JAX package's config.py:314-329
                population_size=int(overrides.get("population_size", exp.get("population_size", 1000))),
                num_elites=int(exp.get("num_elites", 1)),
                selection_threshold=int(exp.get("selection_threshold", 20)),
                mutation_power=c.get("noise_stdev", 0.002),
                noise_stdev=c.get("noise_stdev", 0.002),
                genome_style="cpu",
                episode_cutoff_mode=overrides.get("episode_cutoff_mode", c.get("episode_cutoff_mode", "env_default")),
                validation_threshold=int(exp.get("validation_threshold", 0)),
                num_validation_episodes=int(exp.get("num_validation_episodes", 0)),
                num_test_episodes=int(exp.get("num_test_episodes", 0)),
                **ga_knobs,
            )
            ctor = _pick(RSTrainer if algo == "rs" else GATrainer, env, overrides)
            return ctor(env, model, cfg, noise_table=noise_table, seed=seed, device=device)
        if cpu_schema:
            c = exp["config"]
            cfg = ESConfig(
                l2coeff=c.get("l2coeff", 0.005),
                noise_stdev=c.get("noise_stdev", 0.02),
                population_size=int(overrides.get("population_size", exp.get("population_size", 0))),
                episodes_per_batch=int(overrides.get("episodes_per_batch", c.get("episodes_per_batch", 0))),
                timesteps_per_batch=int(overrides.get("timesteps_per_batch", c.get("timesteps_per_batch", 0))),
                eval_prob=c.get("eval_prob", 0.0),
                snapshot_freq=int(c.get("snapshot_freq", 0)),
                return_proc_mode=c.get("return_proc_mode", "centered_rank"),
                episode_cutoff_mode=overrides.get("episode_cutoff_mode", c.get("episode_cutoff_mode", "env_default")),
                num_eval_episodes=int(overrides.get("num_eval_episodes", default_eval_episodes(c))),
                calc_obstat_prob=c.get("calc_obstat_prob", 0.0),
                mirror_crn=bool(overrides.get("mirror_crn", c.get("mirror_crn", False))),
                **budget,
                **{k: int(overrides[k]) for k in ("eval_batch", "grad_chunk") if k in overrides},
            )
            tr = _es_trainer(env, model, cfg, exp, noise_table, seed, device, overrides)
            init_from = model_args.get("init_from")
            if init_from:  # warm start (es.py:165-167 → policies.py:219-249)
                tr.theta = checkpoint.initialize_from(init_from, model, tr.theta)
            return tr
        if algo == "es":
            cfg = ESConfig(
                l2coeff=exp.get("l2coeff", 0.005),
                noise_stdev=exp.get("mutation_power", 0.02),
                population_size=int(exp["population_size"]),
                return_proc_mode=exp.get("return_proc_mode", "centered_rank"),
                episode_cutoff_mode=exp.get("episode_cutoff_mode", "env_default"),
                mirror_crn=bool(overrides.get("mirror_crn", exp.get("mirror_crn", False))),
                **budget,
                **{k: int(overrides[k]) for k in ("num_eval_episodes", "eval_batch", "grad_chunk") if k in overrides},
            )
            tr = _es_trainer(env, model, cfg, exp, noise_table, seed, device, overrides)
            if "load_from" in exp:  # the GA-seeded ES: θ₀ from a pickled seed chain (gpu es.py:164-171)
                seeds = checkpoint.load_pickle(exp["load_from"].format(**exp))
                tr.theta = checkpoint.theta_from_seed_chain(model, tr.noise, seeds).to(tr.device)
            return tr
        cfg = GAConfig(
            population_size=int(exp["population_size"]),
            selection_threshold=int(exp.get("selection_threshold", 0)),
            validation_threshold=int(exp.get("validation_threshold", 10)),
            num_validation_episodes=int(exp.get("num_validation_episodes", 30)),
            num_test_episodes=int(exp.get("num_test_episodes", 200)),
            mutation_power=exp.get("mutation_power", 0.002),
            episode_cutoff_mode=exp.get("episode_cutoff_mode", "env_default"),
            timesteps=float(exp.get("timesteps", 1e9)),
            **ga_knobs,
        )
        ctor = _pick(RSTrainer if algo == "rs" else GATrainer, env, overrides)
        tr = ctor(env, model, cfg, noise_table=noise_table, seed=seed, device=device)
        if "load_population" in exp:  # gpu ga.py:161-162
            tr.copy_population(exp["load_population"])
        return tr
    except BaseException:
        if getattr(env, "is_host_env", False):
            env.close()  # the trainer that would own the engine does not exist
        raise


def _noise_source(overrides: Dict[str, Any], device, noise_table):
    """The noise source the overrides ask for (the JAX package's
    config.py:189-208), else ``noise_table`` (None: the trainer builds the
    reference's)."""
    noise = overrides.get("noise")
    count = int(overrides.get("noise_size", DEFAULT_COUNT))
    if noise is not None and noise not in _NOISE_SOURCES:
        raise ValueError(f"unknown noise source {noise!r}; the 'noise' override takes {_NOISE_SOURCES}")
    if "noise_seed" in overrides and noise != "device":
        raise ValueError("the 'noise_seed' override applies to 'noise': 'device' only")
    if noise == "virtual":
        return VirtualNoise.from_seed(count=count, device=device)
    if noise == "device":
        return NoiseTable.from_key(prng_key(int(overrides.get("noise_seed", 123))), count=count, device=device)
    if "noise_size" in overrides:
        return NoiseTable.from_seed(count=count, device=device)
    return noise_table


def _nses_trainer(env, model, exp: Dict[str, Any], overrides, budget, noise_table, seed: int, device) -> NSESTrainer:
    """The JAX package's NS branch (its config.py:330-361)."""
    c, ns = exp["config"], exp.get("novelty_search", {})
    # Atari NS-ES characterizes behavior by the per-step RAM trajectory
    # (policies.py:410-418), the device envs and the vector engines by the
    # final state (the JAX package's config.py:334-340)
    image_engine = getattr(env, "is_host_env", False) and getattr(env, "host_obs", "image") == "image"
    default_bc = "traj" if image_engine else "final"
    cfg = NSESConfig(
        l2coeff=c.get("l2coeff", 0.005),
        noise_stdev=c.get("noise_stdev", 0.02),
        population_size=int(overrides.get("population_size", c.get("episodes_per_batch", 128))),
        return_proc_mode=c.get("return_proc_mode", "centered_sign_rank"),
        episode_cutoff_mode=overrides.get("episode_cutoff_mode", c.get("episode_cutoff_mode", "env_default")),
        algo_type=exp.get("algo_type", "ns"),
        k=int(ns.get("k", 10)),
        meta_population_size=int(ns.get("population_size", 3)),
        num_rollouts=int(ns.get("num_rollouts", 1)),
        selection_method=ns.get("selection_method", "novelty_prob"),
        bc_mode=overrides.get("bc_mode", ns.get("bc_mode", default_bc)),
        # the reference's NS-ES workers sample obs stats with the file's
        # calc_obstat_prob (nses.py:197-198); the JAX package's loader drops it
        calc_obstat_prob=c.get("calc_obstat_prob", 0.0),
        **budget,
    )
    return _es_trainer(env, model, cfg, exp, noise_table, seed, device, overrides, NSESTrainer)


def _es_trainer(env, model, cfg: ESConfig, exp: Dict[str, Any], noise_table, seed: int, device, overrides,
                ctor=ESTrainer) -> ESTrainer:
    opt_cfg = exp.get("optimizer", {"type": "adam", "args": {"stepsize": 0.01}})
    return _pick(ctor, env, overrides)(
        env,
        model,
        cfg,
        optimizer=optim.make_optimizer(opt_cfg["type"], **opt_cfg["args"]),
        noise_table=noise_table,
        seed=seed,
        device=device,
    )
