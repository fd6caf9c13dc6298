"""Deceptive Hard Maze: ES against NS-ES on one card, in the PyTorch port.

The port's counterpart of scripts/run_maze_comparison.py. The reference's
scientific headline (its README.md:13-19, nses.py): reward-driven ES gets
trapped in the maze's cul-de-sac (the fitness gradient points into it),
while novelty search (NS-ES) ignores reward and escapes. This script runs
that comparison with deep_neuroevolution_torch's trainers, at the JAX
script's settings, and writes

    results/maze_comparison_torch.json
      { "meta": {...}, "device": {the card, the host},
        "es":   {"best_offspring_dist": ..., "parent_dist_curve": [...], ...},
        "nses": {"best_offspring_dist": ..., "parent_dist_curve": [...], ...} }

with the JAX artifact's keys, plus each run's seconds a generation
(``s_per_gen``). Distance to the goal = −return (the maze reward is
−distance at the episode's end, tf_maze.cpp:77-93). The goal chamber is
under ~5 units once entered; the trap's floor is ~39-40 units.

Run: python scripts/run_maze_comparison_torch.py [--es_gens 300]
     [--ns_iters 3000] [--out results/maze_comparison_torch.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer  # noqa: E402
from deep_neuroevolution_torch.algos.nses import NSESConfig, NSESTrainer  # noqa: E402
from deep_neuroevolution_torch.algos.rollout import rollout_batch  # noqa: E402
from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.envs import MazeEnv  # noqa: E402
from deep_neuroevolution_torch.models import ContinuousMLP  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable  # noqa: E402
from deep_neuroevolution_torch.ops.optim import Adam  # noqa: E402
from deep_neuroevolution_torch.utils import machine, tabular  # noqa: E402


def make_eval(env, model):
    """``eval_theta(theta) -> (return, bc)``: one episode of θ from the
    maze's reset state (deterministic: every slot starts at the start, and
    the ContinuousMLP draws no action noise) to the env's default cutoff,
    through ``rollout_batch`` on θ's device."""
    act = model.make_batch_act()

    def eval_theta(theta: torch.Tensor):
        state = env.reset(1, None, theta.device)
        res = rollout_batch(env, act, (theta[None], None), state, env.default_timestep_cutoff)
        return float(res.returns[0]), res.bc[0].cpu().numpy()

    return eval_theta


def run_es(table, gens, eval_every, log, population=512, device=None):
    device = resolve_device(device)
    env = MazeEnv()
    model = ContinuousMLP(obs_dim=11, ac_dim=2)
    cfg = ESConfig(
        noise_stdev=0.05, population_size=population, num_eval_episodes=0,
        episode_cutoff_mode="env_default", return_proc_mode="centered_rank",
    )
    tr = ESTrainer(env, model, cfg, optimizer=Adam(stepsize=0.05), noise_table=table, seed=0, device=device)
    ev = make_eval(env, model)
    curve, seconds, best = [], [], float("inf")
    t0 = time.time()
    for it in range(gens):
        stats = tr.train_step()
        seconds.append(stats.seconds)
        best = min(best, -float(np.max(stats.returns)))
        if (it + 1) % eval_every == 0 or it == gens - 1:
            ret, bc = ev(tr.theta)
            dist = -ret
            curve.append({"gen": it + 1, "parent_dist": dist, "bc": bc.tolist()})
            log(f"ES gen {it + 1}: parent dist {dist:.2f} (best offspring ever {best:.2f})")
    return {
        "algo": "es", "generations": gens, "population": population,
        "best_offspring_dist": best,
        "final_parent_dist": curve[-1]["parent_dist"],
        "parent_dist_curve": curve,
        "wall_s": round(time.time() - t0, 1),
        "s_per_gen": seconds,
    }


def run_nses(table, iters, eval_every, log, algo_type="ns", stepsize=0.01, sigma=0.05,
             selection="novelty_prob", population=256, device=None):
    device = resolve_device(device)
    env = MazeEnv()
    model = ContinuousMLP(obs_dim=11, ac_dim=2)
    cfg = NSESConfig(
        noise_stdev=sigma, population_size=population, num_eval_episodes=0,
        episode_cutoff_mode="env_default",
        # the default return_proc_mode="centered_sign_rank" ranks the
        # novelty column (nses.py:221-222); "centered_rank" would rank
        # reward and make NS-ES plain ES
        algo_type=algo_type, k=10, meta_population_size=3, num_rollouts=1,
        selection_method=selection,
    )
    tr = NSESTrainer(env, model, cfg, optimizer=Adam(stepsize=stepsize), noise_table=table, seed=0, device=device)
    ev = make_eval(env, model)
    curve, seconds, best = [], [], float("inf")
    t0 = time.time()
    for it in range(iters):
        stats = tr.train_step()
        seconds.append(stats.seconds)
        best = min(best, -float(np.max(stats.returns)))
        if (it + 1) % eval_every == 0 or it == iters - 1:
            dists = [-ev(parent.theta)[0] for parent in tr.parents]
            archive = int(tr.archive.count)
            curve.append({"iter": it + 1, "parent_dists": dists, "archive_size": archive})
            log(f"{algo_type.upper()}-ES iter {it + 1}: parent dists {[f'{d:.1f}' for d in dists]} "
                f"best offspring ever {best:.2f} archive {archive}")
        if best < 5.0:  # the goal chamber reached: the deception escaped
            log(f"{algo_type.upper()}-ES reached the goal region at iter {it + 1}")
            break
    return {
        "algo": f"{algo_type}es", "iterations": it + 1, "population": population,
        "meta_population": 3, "best_offspring_dist": best,
        "final_parent_dists": curve[-1]["parent_dists"] if curve else [],
        "parent_dist_curve": curve,
        "wall_s": round(time.time() - t0, 1),
        "s_per_gen": seconds,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--es_gens", type=int, default=300)
    ap.add_argument("--ns_iters", type=int, default=3000)
    ap.add_argument("--eval_every", type=int, default=25)
    ap.add_argument("--out", default="results/maze_comparison_torch.json")
    ap.add_argument("--ns_only", action="store_true", help="skip the ES phase")
    ap.add_argument("--ns_stepsize", type=float, default=0.01)
    ap.add_argument("--ns_sigma", type=float, default=0.05)
    ap.add_argument("--ns_selection", default="novelty_prob", choices=["novelty_prob", "round_robin"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    def log(msg):
        print(msg, flush=True)

    table = NoiseTable.from_seed(count=5_000_000, device=device)
    out = {"meta": {
        "maze_trap_dist": "~39-40 (cul-de-sac floor)",
        "maze_goal_dist": "<5 (goal chamber)",
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }}
    with tabular.quiet():
        if not args.ns_only:
            out["es"] = run_es(table, args.es_gens, args.eval_every, log, device=device)
        out["nses"] = run_nses(table, args.ns_iters, args.eval_every, log, stepsize=args.ns_stepsize,
                               sigma=args.ns_sigma, selection=args.ns_selection, device=device)
    out["device"] = machine.describe(device)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    es_best = out.get("es", {}).get("best_offspring_dist")
    log(f"ES best {es_best if es_best is not None else 'skipped'} vs "
        f"NS-ES best {out['nses']['best_offspring_dist']:.2f} → {args.out}")
    return out


if __name__ == "__main__":
    main()
