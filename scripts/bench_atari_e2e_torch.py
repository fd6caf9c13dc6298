"""End-to-end Atari-shaped ES generation of the port on the card, split
into its phases.

The port's counterpart of scripts/bench_atari_e2e.py: the full
``ESTrainer.train_step`` on the ToyCatch engine with the VBN-DQN in bf16
(the 'auto' split route, kernel K1 for the fc; kernel K2 in the update) at
pop ≥ 512, with the generation's wall clock split into:

  vbn_stats           ``VirtualBNDQN.batch_ref_stats`` (the per-round VBN
                      pass), the card synced after each call
  host_engine         the engine's ``step`` and ``observe_gray`` (the
                      simulator side, native/bridge.py)
  update              ``ESTrainer._compute_update``: ranks, the gradient
                      (K2) and Adam, the card synced after
  other_dispatch_rtt  the rest: the forward dispatches, the pageable frame
                      uploads (algos/rollout_host.py ``_frames_to``) and
                      the Python glue

A warm-up generation runs first (the kernel library's build and load, the
first allocations) and is left out. The phases sum to ``s_per_generation``
by construction (``other_dispatch_rtt`` is the remainder).

The noise table's size is ``TABLE_COUNT`` (the JAX script's 50M floats).
With ``--device cpu`` the generation runs the kernels' plain versions on
the host: a check of the control flow, not a measurement.

Output: ``--out`` (default results/bench_e2e_torch.json), with the keys of
results/bench_e2e_r03.json plus ``device`` (``utils/machine.py``).

Usage: python scripts/bench_atari_e2e_torch.py [--pop 512] [--slots 64]
       [--cutoff 200] [--gens 2] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer  # noqa: E402
from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.envs.atari import AtariEnv  # noqa: E402
from deep_neuroevolution_torch.models.batchnorm import VirtualBNDQN  # noqa: E402
from deep_neuroevolution_torch.ops import optim  # noqa: E402
from deep_neuroevolution_torch.ops.noise import NoiseTable  # noqa: E402
from deep_neuroevolution_torch.utils import machine, tabular  # noqa: E402

TABLE_COUNT = 50_000_000  # floats of the noise table (the JAX script's)


class PhaseClock:
    """Seconds spent in each wrapped call, by phase name."""

    def __init__(self, device: torch.device):
        self.t = {}
        self.device = device

    def wrap(self, name, fn, sync=False):
        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.t[name] = self.t.get(name, 0.0) + (time.perf_counter() - t0)
            return out

        return timed


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--pop", type=int, default=512)
    p.add_argument("--slots", type=int, default=64)
    p.add_argument("--cutoff", type=int, default=200)
    p.add_argument("--gens", type=int, default=2)
    p.add_argument("--out", default="results/bench_e2e_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    env = AtariEnv("toy", batch_size=args.slots, pipeline_groups=2)
    model = VirtualBNDQN(num_actions=env.num_actions, compute_dtype="bfloat16")
    cfg = ESConfig(population_size=args.pop, noise_stdev=0.02, num_eval_episodes=0,
                   episode_cutoff_mode=args.cutoff)
    try:
        tr = ESTrainer(env, model, cfg, optimizer=optim.Adam(stepsize=0.01),
                       noise_table=NoiseTable.from_seed(count=TABLE_COUNT, device=device), seed=0, device=device)
        clock = PhaseClock(device)
        orig_stats = VirtualBNDQN.batch_ref_stats
        VirtualBNDQN.batch_ref_stats = clock.wrap("vbn_stats", orig_stats, sync=True)
        try:
            env._env.step = clock.wrap("host_engine", env._env.step)
            env._env.observe_gray = clock.wrap("host_engine", env._env.observe_gray)
            tr._compute_update = clock.wrap("update", tr._compute_update, sync=True)

            with tabular.quiet():
                t0 = time.perf_counter()
                tr.train_step()  # warm-up: the kernels' build and load, the first allocations
                print(f"warm-up gen: {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)

                clock.t = {}
                t0 = time.perf_counter()
                episodes = timesteps = 0
                for _ in range(args.gens):
                    st = tr.train_step()
                    episodes += int(np.asarray(st.lengths).size)
                    timesteps += int(np.asarray(st.lengths).sum())
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
        finally:
            VirtualBNDQN.batch_ref_stats = orig_stats
    finally:
        env.close()

    per_gen = wall / args.gens
    phases = {k: v / args.gens for k, v in clock.t.items()}
    phases["other_dispatch_rtt"] = per_gen - sum(phases.values())
    out = {
        "date": time.strftime("%Y-%m-%d"),
        "workload": f"toy engine B={args.slots} slots, VBN-DQN bf16, pop {args.pop}, cutoff {args.cutoff} engine-steps",
        "platform": device.type,
        "gens": args.gens,
        "s_per_generation": per_gen,
        "phase_s_per_generation": phases,
        "episodes_per_gen": episodes / args.gens,
        "member_steps_per_s": timesteps / wall,
        "frames_per_s": timesteps * 4 / wall,  # frameskip 4
        "note": "host clock around train_step, the card synced at the end and after each vbn_stats and update "
                "call; 'other_dispatch_rtt' is the remainder: the forward dispatches, the pageable frame uploads "
                "(algos/rollout_host.py _frames_to) and the Python glue"
                + ("" if device.type == "cuda" else "; run on the CPU: a check of the control flow, not a measurement"),
        "device": machine.describe(device),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in ("s_per_generation", "phase_s_per_generation", "frames_per_s")}),
          flush=True)
    return out


if __name__ == "__main__":
    main()
