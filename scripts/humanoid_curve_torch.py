"""Humanoid ES learning curves in the PyTorch port.

The port's counterpart of scripts/humanoid_curve.py. It runs the
reference Humanoid workload, the 256×256 tanh MujocoMLP with obs
normalization (configurations/humanoid.json → es_distributed/policies.py:
122-206), through the port's ESTrainer on the MuJoCo host engine, with the
reference's calc_obstat_prob Bernoulli obs-stat sampling active
(es.py:356-363), for several seeds, and writes the learning curves and the
obs-stat accounting:

    results/humanoid_curve_torch.json
      { "config": {...}, "workload": "...",
        "seeds": {"0": {"curve", "eval_curve", "ep_len", "ob_counts",
                        "timesteps", "obstat_fraction", "s_per_gen"}, ...},
        "first_gen_mean", "final_gen_mean", "improved_all_seeds",
        "device": {the card or 'cpu', the host} }

with the JAX artifact's keys, plus each generation's seconds
(``s_per_gen``) and ``device``. The population is the JAX script's
reduced one (128 against the reference's episodes_per_batch 10000). The
success criterion is the reference's qualitative one: reward growth from
the random policy's ~130 an episode, the obs-stat count tracking the
sampled fraction.

The physics runs on the host (gymnasium and mujoco); the policy forward,
the gradient (kernel K2 on a card) and the update on ``--device``:

    python scripts/humanoid_curve_torch.py [--seeds 3] [--gens 40] [--device cpu]

With ``--resume_dir`` each seed writes its trainer snapshot and its curve
every generation and a restart continues where it stopped, so seeds can
run one an OS process (``--seed_list 1``) and a last call over all of them
(``--seed_list 0,1,2`` with the same directory) only writes the artifact.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer  # noqa: E402
from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.models import MujocoMLP  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable  # noqa: E402
from deep_neuroevolution_torch.ops.optim import Adam  # noqa: E402
from deep_neuroevolution_torch.utils import checkpoint, machine, tabular  # noqa: E402

ENV_ID = "Humanoid-v5"
TABLE_COUNT = 5_000_000


def make_env(batch_size: int):
    """The host engine the seeds run on: Humanoid-v5 on ``batch_size``
    MuJoCo slots."""
    from deep_neuroevolution_torch.envs.mujoco import MujocoHostEnv

    return MujocoHostEnv(ENV_ID, batch_size=batch_size)


def make_trainer(seed: int, pop: int, batch_size: int, tslimit: int, obstat_prob: float, device=None) -> ESTrainer:
    """The JAX script's trainer: humanoid.json's policy (hidden [256, 256],
    tanh, ac_noise_std 0.01; policies.py:122-206) and config block (σ 0.02,
    l2coeff 0.005, the cutoff DSL's ``tslimit``), 4 eval episodes, Adam
    0.01 and the 5M-float table."""
    device = resolve_device(device)
    env = make_env(batch_size)
    sp = env.action_space
    model = MujocoMLP(obs_dim=env.obs_shape[0], ac_dim=sp.dim, ac_low=tuple(sp.low), ac_high=tuple(sp.high),
                      hidden_dims=(256, 256), nonlin_type="tanh", ac_noise_std=0.01)
    cfg = ESConfig(noise_stdev=0.02, l2coeff=0.005, population_size=pop, num_eval_episodes=4,
                   calc_obstat_prob=obstat_prob, episode_cutoff_mode=tslimit)
    return ESTrainer(env, model, cfg, optimizer=Adam(stepsize=0.01),
                     noise_table=NoiseTable.from_seed(count=TABLE_COUNT, device=device), seed=seed,
                     device=device)


def run_seed(seed: int, gens: int, pop: int, batch_size: int, tslimit: int, obstat_prob: float,
             resume_dir: str = None, device=None) -> dict:
    """One seed's curve. With ``resume_dir``, the trainer snapshot
    (``utils/checkpoint.save_trainer``: θ, Adam, the obs stat, the cutoff
    curriculum and the generator) and the curve so far are written every
    generation, and a restart continues where the previous process
    stopped."""
    tr = make_trainer(seed, pop, batch_size, tslimit, obstat_prob, device)
    curve, eval_curve, lens, obcounts, seconds = [], [], [], [], []
    ckpt = jpath = None
    try:
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            ckpt = os.path.join(resume_dir, f"seed{seed}.ckpt")
            jpath = os.path.join(resume_dir, f"seed{seed}.json")
            if os.path.exists(ckpt) and os.path.exists(jpath):
                checkpoint.load_trainer(ckpt, tr)
                with open(jpath) as f:
                    prev = json.load(f)
                curve, eval_curve, lens, obcounts, seconds = (prev[k] for k in ("curve", "eval_curve", "ep_len",
                                                                                "ob_counts", "s_per_gen"))
                print(f"seed {seed}: resumed at gen {len(curve)}", file=sys.stderr, flush=True)
        with tabular.quiet():
            for g in range(len(curve), gens):
                st = tr.train_step()
                curve.append(float(st.returns.mean()))
                eval_curve.append(float(st.eval_returns.mean()) if st.eval_returns.size else float("nan"))
                lens.append(float(st.lengths.mean()))
                obcounts.append(float(tr.ob_stat.count))
                seconds.append(st.seconds)
                print(f"seed {seed} gen {g}: rew {curve[-1]:.1f} eval {eval_curve[-1]:.1f} len {lens[-1]:.0f} "
                      f"obcount {obcounts[-1]:.0f} ({sum(seconds):.0f}s)", file=sys.stderr, flush=True)
                if resume_dir:
                    checkpoint.save_trainer(ckpt, tr)
                    with open(jpath + ".tmp", "w") as f:
                        json.dump({"curve": curve, "eval_curve": eval_curve, "ep_len": lens, "ob_counts": obcounts,
                                   "timesteps": int(tr.timesteps_so_far), "s_per_gen": seconds}, f)
                    os.replace(jpath + ".tmp", jpath)
        total_ts = tr.timesteps_so_far
    finally:
        tr.close()
    return {
        "curve": curve, "eval_curve": eval_curve, "ep_len": lens,
        "ob_counts": obcounts, "timesteps": int(total_ts),
        # calc_obstat_prob semantics check: sampled fraction of total steps
        "obstat_fraction": obcounts[-1] / max(total_ts, 1),
        "s_per_gen": seconds,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seed_list", default=None,
                   help="comma-separated explicit seeds (overrides --seeds); "
                        "lets one seed run per OS process for parallel campaigns")
    p.add_argument("--gens", type=int, default=40)
    p.add_argument("--pop", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--tslimit", type=int, default=1000)
    p.add_argument("--obstat_prob", type=float, default=0.01)
    p.add_argument("--out", default="results/humanoid_curve_torch.json")
    p.add_argument("--resume_dir", default=None,
                   help="per-gen checkpoints + incremental per-seed JSON here; "
                        "restarts continue (long runs survive interruptions)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    seeds = {}
    seed_values = [int(s) for s in args.seed_list.split(",")] if args.seed_list else list(range(args.seeds))
    for s in seed_values:
        seeds[str(s)] = run_seed(s, args.gens, args.pop, args.batch_size, args.tslimit, args.obstat_prob,
                                 resume_dir=args.resume_dir, device=device)
    finals = np.array([v["curve"][-1] for v in seeds.values()])
    firsts = np.array([v["curve"][0] for v in seeds.values()])
    out = {
        "config": vars(args),
        "workload": "Humanoid-v5, 256x256 tanh MujocoMLP, calc_obstat_prob active "
                    "(configurations/humanoid.json reduced-pop variant)",
        "seeds": seeds,
        "first_gen_mean": float(firsts.mean()),
        "final_gen_mean": float(finals.mean()),
        "improved_all_seeds": bool(all(v["curve"][-1] > v["curve"][0] for v in seeds.values())),
        "device": machine.describe(device),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("first_gen_mean", "final_gen_mean", "improved_all_seeds")}))
    return out


if __name__ == "__main__":
    main()
