"""Experiment configuration, GPU-stack schema.

The counterpart of the JAX package's utils/config.py for the flat schema of
gpu_implementation/configurations/*.json ("game", "model",
"population_size", "episode_cutoff_mode", "mutation_power", "l2coeff",
"return_proc_mode", "optimizer", and the GA's "selection_threshold",
"validation_threshold", "num_validation_episodes", "num_test_episodes",
"timesteps"). The algorithm is ``algo`` if given, else GA when the file has
"selection_threshold" and ES otherwise (config.py:213, 247-261 of the JAX
package); ``"rs"`` runs random search on a GA file.

``overrides`` patches a run without editing the file:

* ``game`` — the env to run instead of the file's game. The port's engine
  has no ALE, so an Atari experiment runs on ``"toy"`` (ToyCatch);
* ``population_size`` and ``episode_cutoff_mode`` — the file's fields;
* ``env_kwargs`` — engine knobs: ``batch_size`` (slots, default 256),
  ``num_threads``, ``pipeline_groups``;
* ``noise_size`` — noise-table length (default 250M, the reference's);
* ``theta_hbm_budget`` — bytes allowed for one round's θ batch;
* ``num_eval_episodes`` — ES only: noiseless episodes of θ per generation
  (default 8).

Not ported yet, and rejected with ``NotImplementedError`` rather than
dropped: the experiment keys ``load_population`` (GA population import),
``load_from`` (GA-seeded ES) and ``mirror_crn`` (mirrored common random
numbers), and the ``mirror_crn`` override. Rejected as unsupported: the
``eval_batch`` and ``grad_chunk`` overrides (the device arms' chunks). Also
not ported: the CPU-stack schema, NS-ES and device envs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .. import models
from ..algos.es import ESConfig, ESTrainer
from ..algos.ga import GAConfig, GATrainer, RSTrainer
from ..device import resolve_device
from ..envs.atari import AtariEnv
from ..ops import optim
from ..ops.noise import NoiseTable

_OVERRIDES = {
    "game", "population_size", "episode_cutoff_mode", "env_kwargs", "noise_size", "theta_hbm_budget",
    "num_eval_episodes",
}
# keys the JAX package acts on (its utils/config.py:222, 233-245, 260-261)
_UNPORTED_KEYS = ("load_population", "load_from", "mirror_crn")


def load_experiment(
    exp: Dict[str, Any],
    seed: int = 0,
    overrides: Optional[Dict[str, Any]] = None,
    device=None,
    algo: Optional[str] = None,
):
    """Experiment dict → ready ES, GA or RS trainer on ``device`` (default
    cuda)."""
    overrides = dict(overrides or {})
    if "mirror_crn" in overrides:
        raise NotImplementedError("the 'mirror_crn' override is not ported yet")
    unknown = set(overrides) - _OVERRIDES
    if unknown:
        raise ValueError(f"unsupported overrides {sorted(unknown)}; supported: {sorted(_OVERRIDES)}")
    for key in _UNPORTED_KEYS:
        if key in exp:
            raise NotImplementedError(f"experiment key {key!r} is not ported yet")
    if "game" not in exp:
        raise NotImplementedError("only the GPU-stack schema (a 'game' field) is ported yet")
    algo = algo or ("ga" if "selection_threshold" in exp else "es")
    if algo not in ("es", "ga", "rs"):
        raise NotImplementedError(f"algo {algo!r} is not ported yet; ported: es, ga, rs")
    if "num_eval_episodes" in overrides and algo != "es":
        raise ValueError("the 'num_eval_episodes' override applies to ES only")
    device = resolve_device(device)
    exp = {**exp, **{k: overrides[k] for k in ("game", "population_size", "episode_cutoff_mode") if k in overrides}}
    budget = {k: overrides[k] for k in ("theta_hbm_budget",) if k in overrides}
    evals = {k: int(overrides[k]) for k in ("num_eval_episodes",) if k in overrides}
    # 256 engine slots unless env_kwargs says otherwise (the JAX package's
    # Atari default, config.py _atari_defaults)
    env = AtariEnv(exp["game"], **{"batch_size": 256, **overrides.get("env_kwargs", {})})
    try:
        model = models.get_model(exp["model"])(num_actions=env.num_actions)
        noise_table = None
        if "noise_size" in overrides:
            noise_table = NoiseTable.from_seed(count=int(overrides["noise_size"]), device=device)
        if algo == "es":
            opt_cfg = exp.get("optimizer", {"type": "adam", "args": {"stepsize": 0.01}})
            cfg = ESConfig(
                l2coeff=exp.get("l2coeff", 0.005),
                noise_stdev=exp.get("mutation_power", 0.02),
                population_size=int(exp["population_size"]),
                return_proc_mode=exp.get("return_proc_mode", "centered_rank"),
                episode_cutoff_mode=exp.get("episode_cutoff_mode", "env_default"),
                **budget,
                **evals,
            )
            return ESTrainer(
                env,
                model,
                cfg,
                optimizer=optim.make_optimizer(opt_cfg["type"], **opt_cfg["args"]),
                noise_table=noise_table,
                seed=seed,
                device=device,
            )
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
        env.close()  # the trainer that would own the engine does not exist
        raise
