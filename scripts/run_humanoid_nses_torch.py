"""Deceptive humanoid: ES against NS-ES on the trap world, in the PyTorch port.

The port's counterpart of scripts/run_humanoid_nses.py. The reference's
second headline (README.md:82-84, extra/humanoid_maze.xml): forward
progress, the reward's gradient, walks the humanoid into a U-shaped wall
trap; reward-driven ES converges into it, and novelty search (NS-ES over
the final mass centre (x, y), policies.py:293-296) must go round it.

At the JAX script's reduced population, the script records the measurable
signature of that phenomenon: each generation's final-position BC cloud
(ES) or new archive point (NS-ES), the NS-ES archive's coverage of (x, y)
at the end against ES's reward-driven cluster, and each arm's forward
progress against the trap's geometry (``--trap_distance``, the wall's
distance ahead of the start). Writes

    results/humanoid_nses_torch.json
      { "config": {...}, "workload": "...",
        "es":   {"history": {"mean_ret", "mean_len", "bc_x", "bc_y",
                             "s_per_gen"}, "trap_distance"},
        "nses": {"history": {...}, "trap_distance", "archive_points",
                 "archive_x_max", "archive_abs_y_max", "archive_spread"},
        "device": {the card or 'cpu', the host} }

with the JAX artifact's keys, plus each generation's seconds and
``device``. Resumable per generation with ``--resume_dir``, as
scripts/humanoid_curve_torch.py:

    python scripts/run_humanoid_nses_torch.py [--gens 150] [--arms es,nses]
        [--resume_dir results/humanoid_nses_ckpt_torch] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer  # noqa: E402
from deep_neuroevolution_torch.algos.nses import NSESConfig, NSESTrainer  # noqa: E402
from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.models import MujocoMLP  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable  # noqa: E402
from deep_neuroevolution_torch.ops.optim import Adam  # noqa: E402
from deep_neuroevolution_torch.utils import checkpoint, machine, tabular  # noqa: E402

TABLE_COUNT = 5_000_000


def _mk_env(batch_size, trap_distance, seed_base):
    """Humanoid-v5 in the trap world on ``batch_size`` MuJoCo slots, the
    final mass centre as the BC. ``seed_base`` is not used, as in the JAX
    script: episodes take their seeds from each rollout's seed."""
    from deep_neuroevolution_torch.envs import mujoco

    return mujoco.MujocoHostEnv(
        mujoco.resolve_env_id("Humanoid-v5"),
        xml_file=mujoco.deceptive_humanoid_xml(distance=trap_distance),
        batch_size=batch_size, bc_mode="final_pos",
    )


def _mk_model(env):
    sp = env.action_space
    # humanoid_nses.json policy args (256x256 tanh, ac_noise_std 0.01)
    return MujocoMLP(
        obs_dim=env.obs_shape[0], ac_dim=sp.dim,
        ac_low=tuple(sp.low), ac_high=tuple(sp.high),
        hidden_dims=(256, 256), nonlin_type="tanh", ac_noise_std=0.01,
    )


def make_trainer(arm: str, pop: int, batch_size: int, trap_distance: float, seed: int, device=None):
    """The JAX script's trainer of ``arm``: 'es' (σ 0.02, l2coeff 0.005, 4
    eval episodes, calc_obstat_prob 0.01, cutoff 1000) or 'nses'
    (humanoid_nses.json's novelty_search block: k 10, M 3, novelty_prob,
    the final BC, centered_sign_rank), Adam 0.01, the 5M-float table."""
    device = resolve_device(device)
    env = _mk_env(batch_size, trap_distance, seed)
    model = _mk_model(env)
    noise = NoiseTable.from_seed(count=TABLE_COUNT, device=device)
    if arm == "es":
        cfg = ESConfig(noise_stdev=0.02, l2coeff=0.005, population_size=pop,
                       num_eval_episodes=4, calc_obstat_prob=0.01,
                       episode_cutoff_mode=1000)
        return ESTrainer(env, model, cfg, optimizer=Adam(stepsize=0.01), noise_table=noise, seed=seed, device=device)
    cfg = NSESConfig(noise_stdev=0.02, l2coeff=0.005, population_size=pop,
                     calc_obstat_prob=0.01, episode_cutoff_mode=1000,
                     algo_type="ns", k=10, meta_population_size=3,
                     num_rollouts=1, selection_method="novelty_prob",
                     bc_mode="final", return_proc_mode="centered_sign_rank")
    return NSESTrainer(env, model, cfg, optimizer=Adam(stepsize=0.01), noise_table=noise, seed=seed, device=device)


def run_arm(arm: str, gens: int, pop: int, batch_size: int, trap_distance: float,
            seed: int, resume_dir: str = None, device=None) -> dict:
    """One arm's generations and its summary; with ``resume_dir`` the
    trainer snapshot and the history are written every generation, and a
    restart continues where the previous process stopped."""
    tr = make_trainer(arm, pop, batch_size, trap_distance, seed, device)
    hist = {"mean_ret": [], "mean_len": [], "bc_x": [], "bc_y": [], "s_per_gen": []}
    ckpt = jpath = None
    try:
        if resume_dir:
            os.makedirs(resume_dir, exist_ok=True)
            ckpt = os.path.join(resume_dir, f"{arm}.ckpt")
            jpath = os.path.join(resume_dir, f"{arm}.json")
            if os.path.exists(ckpt) and os.path.exists(jpath):
                checkpoint.load_trainer(ckpt, tr)
                with open(jpath) as f:
                    hist = json.load(f)
                print(f"{arm}: resumed at gen {len(hist['mean_ret'])}", file=sys.stderr, flush=True)
        with tabular.quiet():
            for g in range(len(hist["mean_ret"]), gens):
                st = tr.train_step()
                # ES: the generation's perturbed-rollout BC cloud (final
                # mass centre x, y); NS-ES: the archive point inserted this
                # generation (the updated parent's mean BC), a 1-point
                # cloud; the whole archive is summarized at the end
                flat = (st.bc if arm == "es" else st.new_bc).reshape(-1, 2)
                hist["mean_ret"].append(float(st.returns.mean()))
                hist["mean_len"].append(float(st.lengths.mean()))
                hist["bc_x"].append([float(flat[:, 0].min()), float(flat[:, 0].mean()), float(flat[:, 0].max())])
                hist["bc_y"].append([float(np.abs(flat[:, 1]).max())])
                hist["s_per_gen"].append(st.seconds)
                print(f"{arm} gen {g}: ret {hist['mean_ret'][-1]:.1f} len {hist['mean_len'][-1]:.0f} "
                      f"x_max {hist['bc_x'][-1][2]:.2f} ({sum(hist['s_per_gen']):.0f}s)", file=sys.stderr, flush=True)
                if resume_dir:
                    checkpoint.save_trainer(ckpt, tr)
                    with open(jpath + ".tmp", "w") as f:
                        json.dump(hist, f)
                    os.replace(jpath + ".tmp", jpath)

        # final characterization: the archive's cloud (NS-ES)
        summary = {"history": hist, "trap_distance": trap_distance}
        if arm == "nses":
            pts = tr.archive.points[: int(tr.archive.count)].cpu().numpy()
            summary["archive_points"] = pts.tolist()
            summary["archive_x_max"] = float(pts[:, 0].max())
            summary["archive_abs_y_max"] = float(np.abs(pts[:, 1]).max())
            summary["archive_spread"] = float(pts.std(axis=0).mean())
    finally:
        tr.close()
    return summary


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--gens", type=int, default=150)
    p.add_argument("--pop", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--trap_distance", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arms", default="es,nses")
    p.add_argument("--resume_dir", default="results/humanoid_nses_ckpt_torch")
    p.add_argument("--out", default="results/humanoid_nses_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    out = {"config": vars(args),
           "workload": "HumanoidTrap-v5 (generated trap world, "
                       "envs/mujoco.py deceptive_humanoid_xml), 256x256 tanh "
                       "MujocoMLP, humanoid_nses.json semantics at reduced pop"}
    for arm in args.arms.split(","):
        out[arm] = run_arm(arm, args.gens, args.pop, args.batch_size, args.trap_distance, args.seed,
                           resume_dir=args.resume_dir, device=device)
    out["device"] = machine.describe(device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({a: {"final_ret": out[a]["history"]["mean_ret"][-1]}
                      for a in args.arms.split(",") if a in out}))
    return out


if __name__ == "__main__":
    main()
