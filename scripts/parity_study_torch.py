"""Statistical-parity study of the PyTorch port: does the obs-stat sampling
rate shift learning, and does the eval count leave θ alone?

The port's counterpart of scripts/parity_study.py, with its arms, defaults
and verdict fields, on deep_neuroevolution_torch's trainers:

1. **Eval scheduling.** θ after G generations must be bit for bit the same
   for eval counts 0 and 8 (``eval_bit_identity``): the eval episodes are
   diagnostics and draw nothing the rounds read.
2. **Obs-stat sampling.** N seeds × G generations of ES on the Hard Maze
   with the obs-normalizing MujocoMLP 32×32, under ``calc_obstat_prob``
   1.0 (every rollout joins the running stats) and 0.01 (the reference's
   value, frostbite_es.json), and the eval-return curves of both arms.

Output: results/parity_obstat_torch.json — the JAX artifact's keys (per-seed
curves, final mean ± std per arm, Welch t, the bit-identity check) plus
``device`` (the card and the host); each arm also holds its seconds a
generation (``s_per_gen``), and ``config`` the study's wall seconds.

Run: python scripts/parity_study_torch.py [--seeds 5] [--gens 30]
     [--domain maze|pendulum] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer  # noqa: E402
from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.envs import CartPoleEnv, MazeEnv  # noqa: E402
from deep_neuroevolution_torch.models import LinearClassifier, MujocoMLP  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable  # noqa: E402
from deep_neuroevolution_torch.ops.optim import Adam  # noqa: E402
from deep_neuroevolution_torch.utils import machine, tabular  # noqa: E402

ARMS = ((1.0, "all_rollouts_p1.0"), (0.01, "reference_p0.01"))


def run_arm(obstat_prob: float, seed: int, gens: int, domain: str = "maze", device=None):
    """One seed × one calc_obstat_prob arm; returns (the mean eval return of
    each generation, the obs stats' count at the end, seconds of each
    generation). Domains:

    * 'maze': the device Hard Maze, 400-step episodes, population 256;
    * 'pendulum': MuJoCo's InvertedPendulum-v5 on the host engine (32
      slots, population 64), the long-episode regime where obs-stat
      sampling bites. It needs gymnasium and mujoco and raises without
      them."""
    device = resolve_device(device)
    if domain == "maze":
        env = MazeEnv()
        model = MujocoMLP(obs_dim=11, ac_dim=2, ac_low=(-1.0, -1.0), ac_high=(1.0, 1.0), hidden_dims=(32, 32))
        pop, lr, sigma = 256, 0.05, 0.05
    else:
        from deep_neuroevolution_torch.envs.mujoco import MujocoHostEnv

        env = MujocoHostEnv("InvertedPendulum-v5", batch_size=32)
        sp = env.action_space
        model = MujocoMLP(obs_dim=env.obs_shape[0], ac_dim=sp.dim, ac_low=tuple(sp.low), ac_high=tuple(sp.high),
                          hidden_dims=(16, 16))
        pop, lr, sigma = 64, 0.03, 0.05
    cfg = ESConfig(noise_stdev=sigma, l2coeff=0.005, population_size=pop, num_eval_episodes=8,
                   calc_obstat_prob=obstat_prob)
    tr = ESTrainer(env, model, cfg, optimizer=Adam(stepsize=lr),
                   noise_table=NoiseTable.from_seed(count=2_000_000, device=device), seed=seed, device=device)
    curve, seconds = [], []
    try:
        with tabular.quiet():
            for _ in range(gens):
                st = tr.train_step()
                curve.append(float(st.eval_returns.mean()))
                seconds.append(st.seconds)
    finally:
        tr.close()
    return curve, float(tr.ob_stat.count), seconds


def eval_bit_identity(seed: int = 3, gens: int = 3, device=None) -> bool:
    """θ after ``gens`` CartPole generations is identical for eval counts 0
    and 8."""
    device = resolve_device(device)
    table = NoiseTable.from_seed(count=200_000, device=device)
    thetas = {}
    with tabular.quiet():
        for ne in (0, 8):
            tr = ESTrainer(
                CartPoleEnv(), LinearClassifier(obs_dim=4, num_actions=2),
                ESConfig(noise_stdev=0.2, population_size=32, num_eval_episodes=ne),
                optimizer=Adam(stepsize=0.1), noise_table=table, seed=seed, device=device,
            )
            for _ in range(gens):
                tr.train_step()
            thetas[ne] = tr.theta.cpu().numpy()
    return bool(np.array_equal(thetas[0], thetas[8]))


def verdict(finals_a, finals_b) -> dict:
    """The final-performance comparison of the two arms (p=1.0 first):
    the difference of their means, Welch's t, and whether the difference
    lies within twice the larger seed spread."""
    a, b = np.asarray(finals_a, np.float64), np.asarray(finals_b, np.float64)
    se = np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
    t = float((a.mean() - b.mean()) / max(se, 1e-9))
    seed_spread = float(max(a.std(ddof=1), b.std(ddof=1)))
    return {
        "final_diff": float(a.mean() - b.mean()),
        "welch_t": t,
        "within_seed_variance": bool(abs(a.mean() - b.mean()) <= 2.0 * seed_spread),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--gens", type=int, default=30)
    p.add_argument("--domain", choices=["maze", "pendulum"], default="maze")
    p.add_argument("--out", default="results/parity_obstat_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    arms = {}
    for prob, name in ARMS:
        curves, obcounts, seconds = [], [], []
        for s in range(args.seeds):
            c, oc, secs = run_arm(prob, seed=s, gens=args.gens, domain=args.domain, device=device)
            curves.append(c)
            obcounts.append(oc)
            seconds.append(secs)
            print(f"{name} seed {s}: final={c[-1]:.1f} obcount={oc:.0f} s/gen={np.median(secs):.4f}",
                  file=sys.stderr, flush=True)
        finals = np.array([c[-1] for c in curves])
        arms[name] = {
            "curves": curves,
            "ob_counts": obcounts,
            "final_mean": float(finals.mean()),
            "final_std": float(finals.std(ddof=1)),
            "s_per_gen": seconds,
        }

    out = {
        "config": {**{k: v for k, v in vars(args).items() if k != "device"}, "wall_s": time.time() - t0},
        "arms": arms,
        "verdict": {
            **verdict([c[-1] for c in arms[ARMS[0][1]]["curves"]], [c[-1] for c in arms[ARMS[1][1]]["curves"]]),
            "eval_count_bit_identical_theta": eval_bit_identity(device=device),
        },
        "device": machine.describe(device),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["verdict"]))
    return out


if __name__ == "__main__":
    main()
