"""Experiment configuration: the GPU-stack schema, and the CPU-stack schema's
ES and NS-ES branches.

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
  the JAX package). ``eval_prob`` sets the eval-episode count as there:
  ``eval_prob · episodes_per_batch`` (at least 1) when both are set, else
  8. A file with "novelty_search" (or ``algo`` "nses") runs NS-ES, as the
  JAX package's config.py:330-361 reads it: the population is
  ``episodes_per_batch`` (``timesteps_per_batch`` is not read),
  ``algo_type``, k, M, ``num_rollouts`` and ``selection_method`` come from
  the file, ``bc_mode`` is 'traj' on the host engine and 'final'
  elsewhere, and no eval episodes run.

``resolve_env`` maps env ids onto the registry (envs/core.py ``make``):
'maze', 'gym.<Id>' and 'CartPole-*' are device envs; any other game runs
on the host engine (256 slots unless ``env_kwargs`` says otherwise), whose
only backend here is ToyCatch ('toy'). ``<Game>NoFrameskip-v4`` ids run on
ToyCatch with EpisodicLife on, as the JAX package runs them where ALE is
missing (its config.py:34-53).

``overrides`` patches a run without editing the file:

* ``game`` — the env to run instead of the file's game (GPU schema). The
  port's engine has no ALE, so an Atari experiment runs on ``"toy"``;
* ``population_size`` and ``episode_cutoff_mode`` — the file's fields;
* ``env_kwargs`` — keyword arguments of the env: for the host engine
  ``batch_size`` (slots), ``num_threads``, ``pipeline_groups``;
* ``noise_size`` — noise-table length (default 250M, the reference's);
* ``theta_hbm_budget`` — bytes allowed for one round's θ batch;
* ``num_eval_episodes`` — ES only: noiseless episodes of θ per generation;
* ``bc_mode`` — NS-ES only: 'final' or 'traj'.

Not ported yet, and rejected with ``NotImplementedError`` rather than
dropped: the experiment keys ``load_population`` (GA population import),
``load_from`` (GA-seeded ES) and ``mirror_crn`` (mirrored common random
numbers), and the ``mirror_crn`` override; in the CPU-stack schema, any
``algo`` but es and nses, ES's quota mode (``episodes_per_batch`` or
``timesteps_per_batch`` > 0), the policy's ``init_from`` warm start and
MuJoCo env ids (so ``humanoid_nses.json`` too); NS-ES on a GPU-stack file.
Rejected as unsupported: the ``eval_batch`` and ``grad_chunk`` overrides
(the device arms' chunks).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional

import numpy as np

from .. import envs, models
from ..algos.es import ESConfig, ESTrainer
from ..algos.ga import GAConfig, GATrainer, RSTrainer
from ..algos.nses import NSESConfig, NSESTrainer
from ..device import resolve_device
from ..envs.core import Continuous, Discrete
from ..ops import optim
from ..ops.noise import NoiseTable

_OVERRIDES = {
    "game", "population_size", "episode_cutoff_mode", "env_kwargs", "noise_size", "theta_hbm_budget",
    "num_eval_episodes", "bc_mode",
}
# keys the JAX package acts on (its utils/config.py:222, 233-245, 260-261)
_UNPORTED_KEYS = ("load_population", "load_from", "mirror_crn")
# the JAX package's envs/mujoco.py MUJOCO_FAMILIES: host envs not ported yet
_MUJOCO_FAMILIES = (
    "Humanoid", "HumanoidStandup", "HalfCheetah", "Hopper", "Walker2d", "Ant", "Swimmer", "InvertedPendulum",
    "InvertedDoublePendulum", "Reacher", "Pusher", "HumanoidTrap",
)


def resolve_env(env_id: str, **kwargs):
    """An env id of either schema → a device env or the host engine."""
    if re.fullmatch(r"[A-Za-z0-9]+NoFrameskip-v\d+", env_id):
        # the CPU stack wraps its training envs with wrap_deepmind, whose
        # EpisodicLifeEnv is on by default (atari_wrappers.py:204-222); the
        # engine has no ALE, so ToyCatch stands in for the game
        return envs.make("toy", **{"batch_size": 256, "episodic_life": True, **kwargs})
    if env_id.split("-")[0] == "CartPole":
        env_id = "gym." + env_id
    if env_id == "maze" or env_id.startswith("gym."):
        return envs.make(env_id, **kwargs)
    if env_id.split("-")[0] in _MUJOCO_FAMILIES:
        raise NotImplementedError(f"env id {env_id!r}: the MuJoCo envs are not ported yet")
    return envs.make(env_id, **{"batch_size": 256, **kwargs})  # the JAX package's Atari default


def build_model(policy_type: str, args: Dict[str, Any], env) -> models.Model:
    """A model for ``env`` from a reference policy or model name."""
    if "init_from" in args:
        raise NotImplementedError("the policy's 'init_from' warm start is not ported yet")
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
    if "obs_dim" in getattr(cls, "__dataclass_fields__", {}):
        return cls(obs_dim=int(np.prod(env.obs_shape)), num_actions=num_actions, **kwargs)
    return cls(num_actions=num_actions, **kwargs)


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
    """Experiment dict → ready ES, GA or RS trainer on ``device`` (default
    cuda). ``noise_table``, when given, is used instead of building one
    (so a process that runs several experiments builds it once)."""
    overrides = dict(overrides or {})
    if "mirror_crn" in overrides:
        raise NotImplementedError("the 'mirror_crn' override is not ported yet")
    unknown = set(overrides) - _OVERRIDES
    if unknown:
        raise ValueError(f"unsupported overrides {sorted(unknown)}; supported: {sorted(_OVERRIDES)}")
    cpu_schema = "game" not in exp
    for key in _UNPORTED_KEYS:
        if key in exp or (cpu_schema and key in exp.get("config", {})):
            raise NotImplementedError(f"experiment key {key!r} is not ported yet")
    if cpu_schema:
        if "env_id" not in exp:
            raise ValueError("an experiment needs a 'game' (GPU-stack schema) or an 'env_id' (CPU-stack schema)")
        algo = algo or exp.get("algo") or ("nses" if "novelty_search" in exp else "es")
        if algo == "es":  # NS-ES reads episodes_per_batch as its population
            for quota in ("episodes_per_batch", "timesteps_per_batch"):
                if int(exp["config"].get(quota, 0)) > 0:
                    raise NotImplementedError(f"quota mode ({quota!r} > 0) is not ported yet")
    else:
        algo = algo or ("ga" if "selection_threshold" in exp else "es")
    if algo == "nses" and not cpu_schema:
        raise NotImplementedError("algo 'nses': NS-ES runs CPU-stack files (with 'novelty_search'), not GPU-stack ones")
    ported = ("es", "nses") if cpu_schema else ("es", "ga", "rs")
    if algo not in ported:
        raise NotImplementedError(f"algo {algo!r} is not ported yet for this schema; ported: {', '.join(ported)}")
    if "num_eval_episodes" in overrides and algo != "es":
        raise ValueError("the 'num_eval_episodes' override applies to ES only")
    if "bc_mode" in overrides and algo != "nses":
        raise ValueError("the 'bc_mode' override applies to NS-ES only")
    device = resolve_device(device)
    budget = {k: overrides[k] for k in ("theta_hbm_budget",) if k in overrides}
    if "noise_size" in overrides:
        noise_table = NoiseTable.from_seed(count=int(overrides["noise_size"]), device=device)

    if cpu_schema:
        env_id, model_name, model_args = exp["env_id"], exp["policy"]["type"], exp["policy"].get("args", {})
    else:
        exp = {**exp, **{k: overrides[k] for k in ("game", "population_size", "episode_cutoff_mode") if k in overrides}}
        env_id, model_name, model_args = exp["game"], exp["model"], {}
    env = resolve_env(env_id, **overrides.get("env_kwargs", {}))
    try:
        model = build_model(model_name, model_args, env)
        if algo == "nses":
            return _nses_trainer(env, model, exp, overrides, budget, noise_table, seed, device)
        if cpu_schema:
            c = exp["config"]
            cfg = ESConfig(
                l2coeff=c.get("l2coeff", 0.005),
                noise_stdev=c.get("noise_stdev", 0.02),
                population_size=int(overrides.get("population_size", exp.get("population_size", 0))),
                return_proc_mode=c.get("return_proc_mode", "centered_rank"),
                episode_cutoff_mode=overrides.get("episode_cutoff_mode", c.get("episode_cutoff_mode", "env_default")),
                num_eval_episodes=int(overrides.get("num_eval_episodes", default_eval_episodes(c))),
                calc_obstat_prob=c.get("calc_obstat_prob", 0.0),
                **budget,
            )
            return _es_trainer(env, model, cfg, exp, noise_table, seed, device)
        if algo == "es":
            cfg = ESConfig(
                l2coeff=exp.get("l2coeff", 0.005),
                noise_stdev=exp.get("mutation_power", 0.02),
                population_size=int(exp["population_size"]),
                return_proc_mode=exp.get("return_proc_mode", "centered_rank"),
                episode_cutoff_mode=exp.get("episode_cutoff_mode", "env_default"),
                **budget,
                **{k: int(overrides[k]) for k in ("num_eval_episodes",) if k in overrides},
            )
            return _es_trainer(env, model, cfg, exp, noise_table, seed, device)
        cfg = GAConfig(
            population_size=int(exp["population_size"]),
            selection_threshold=int(exp.get("selection_threshold", 0)),
            validation_threshold=int(exp.get("validation_threshold", 10)),
            num_validation_episodes=int(exp.get("num_validation_episodes", 30)),
            num_test_episodes=int(exp.get("num_test_episodes", 200)),
            mutation_power=exp.get("mutation_power", 0.002),
            episode_cutoff_mode=exp.get("episode_cutoff_mode", "env_default"),
            timesteps=float(exp.get("timesteps", 1e9)),
            **budget,
        )
        ctor = RSTrainer if algo == "rs" else GATrainer
        return ctor(env, model, cfg, noise_table=noise_table, seed=seed, device=device)
    except BaseException:
        if getattr(env, "is_host_env", False):
            env.close()  # the trainer that would own the engine does not exist
        raise


def _nses_trainer(env, model, exp: Dict[str, Any], overrides, budget, noise_table, seed: int, device) -> NSESTrainer:
    """The JAX package's NS branch (its config.py:330-361)."""
    c, ns = exp["config"], exp.get("novelty_search", {})
    # Atari NS-ES characterizes behavior by the per-step RAM trajectory
    # (policies.py:410-418), the device envs by the final state
    default_bc = "traj" if getattr(env, "is_host_env", False) else "final"
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
        **budget,
    )
    return _es_trainer(env, model, cfg, exp, noise_table, seed, device, NSESTrainer)


def _es_trainer(env, model, cfg: ESConfig, exp: Dict[str, Any], noise_table, seed: int, device,
                ctor=ESTrainer) -> ESTrainer:
    opt_cfg = exp.get("optimizer", {"type": "adam", "args": {"stepsize": 0.01}})
    return ctor(
        env,
        model,
        cfg,
        optimizer=optim.make_optimizer(opt_cfg["type"], **opt_cfg["args"]),
        noise_table=noise_table,
        seed=seed,
        device=device,
    )
