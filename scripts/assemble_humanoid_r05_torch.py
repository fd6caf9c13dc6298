"""Assemble the PyTorch port's Humanoid curve artifacts.

The port's counterpart of scripts/assemble_humanoid_r05.py, with its
drift analysis, parity bar and per-seed summary, on paths given as
arguments. By default it reads the port's own campaign
(scripts/humanoid_curve_torch.py):

* seed 0 of ``--curve`` results/humanoid_curve_torch.json, and the
  per-generation JSON of seeds 1 and 2 from ``--resume_dir``
  results/humanoid_ckpt_torch where it exists (the JAX script's seeds) →
  ``--out`` results/humanoid_curve_seeds_torch.json, with a drift analysis
  per seed (rolling peak against the final window);
* ``--long_run`` results/humanoid_pop1000_ckpt_torch/seed0.json, a long
  run's per-generation JSON, where it exists → ``--long_out``
  results/humanoid_curve_pop1000_torch.json.

Each output carries ``device`` (the card or 'cpu' and the host it is
assembled on). It refuses to write a file of the repo's results/ whose name
does not end in ``_torch.json``: the JAX package's artifacts stay as
committed.

The parity bar: Gymnasium Humanoid-v5's "healthy" reward alone is 5 a
step; sustained walking at the reference's quality is >= 6000 episode
reward (1000 steps × (5 healthy + ~1 forward)). Intermediate markers:
> 500 = standing and stepping beyond the ~125 random plateau and still
climbing; >= 1000 = locomotion onset (episode length persistently > 200).

Run: python scripts/assemble_humanoid_r05_torch.py [--curve PATH]
     [--resume_dir DIR] [--out PATH] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.utils import machine  # noqa: E402

# as in the JAX script: seed 0 from the curve artifact, seeds 1 and 2 from
# their per-generation JSON (the longer runs), where it exists
CURVE_SEEDS, DIR_SEEDS = ("0",), ("1", "2")
PARITY_BAR = {
    "walking": ">=6000 mean episode reward (healthy 5/step x 1000 steps "
               "+ forward progress) — the reference design point outcome",
    "locomotion_onset": ">=1000 reward with episode length persistently >200",
    "beyond_random_plateau": ">500 (random policy plateaus ~125, falls at ~27 steps)",
}


def _drift(curve, window=20):
    """peak(rolling mean) vs final rolling mean — the pop-128 signature was
    final << peak (e.g. 248→129 by gen 300)."""
    if len(curve) < 2 * window:
        return None
    roll = [sum(curve[i - window:i]) / window for i in range(window, len(curve) + 1)]
    peak = max(roll)
    final = roll[-1]
    return {"rolling_peak": peak, "rolling_final": final,
            "final_over_peak": final / peak if peak else None,
            "drifting": final < 0.8 * peak}


def _writable(path: str) -> str:
    """``path``, unless it is a file of the repo's results/ that is not the
    port's (``*_torch.json``)."""
    full = os.path.abspath(path)
    if os.path.dirname(full) == os.path.join(REPO, "results") and not full.endswith("_torch.json"):
        raise ValueError(f"{path}: the repo's results/ keeps the JAX package's artifacts; write *_torch.json")
    return full


def _write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def main(argv=None) -> dict:
    """Writes ``--out`` (and ``--long_out`` when ``--long_run`` exists);
    returns ``--out``'s content."""
    p = argparse.ArgumentParser()
    p.add_argument("--curve", default=os.path.join(REPO, "results/humanoid_curve_torch.json"))
    p.add_argument("--resume_dir", default=os.path.join(REPO, "results/humanoid_ckpt_torch"))
    p.add_argument("--out", default=os.path.join(REPO, "results/humanoid_curve_seeds_torch.json"))
    p.add_argument("--long_run", default=os.path.join(REPO, "results/humanoid_pop1000_ckpt_torch/seed0.json"))
    p.add_argument("--long_out", default=os.path.join(REPO, "results/humanoid_curve_pop1000_torch.json"))
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    out, long_out = _writable(args.out), _writable(args.long_out)
    desc = machine.describe(resolve_device(args.device))

    with open(args.curve) as f:
        art = json.load(f)
    seeds = {s: art["seeds"][s] for s in CURVE_SEEDS}
    for s in DIR_SEEDS:
        path = os.path.join(args.resume_dir, f"seed{s}.json")
        if os.path.exists(path):
            with open(path) as f:
                seeds[s] = json.load(f)
    pop = art.get("config", {}).get("pop", "unrecorded")
    res = {
        "workload": f"Humanoid-v5, 256x256 tanh MujocoMLP, calc_obstat_prob=0.01 active, pop {pop} "
                    "(configurations/humanoid.json reduced-pop variant; scripts/humanoid_curve_torch.py)",
        "parity_bar": PARITY_BAR,
        "seeds": {},
    }
    for s, v in seeds.items():
        c = v["curve"]
        res["seeds"][s] = {
            "generations": len(c),
            "curve": c,
            "eval_curve": v.get("eval_curve"),
            "ep_len": v.get("ep_len"),
            "first": c[0], "final": c[-1], "max": max(c),
            "best_eval": max((x for x in v.get("eval_curve", []) if x == x), default=None),
            "drift": _drift(c),
        }
    drifts = [res["seeds"][s]["drift"] for s in res["seeds"] if res["seeds"][s]["drift"]]
    res["no_drift_all_seeds"] = bool(drifts) and not any(d["drifting"] for d in drifts)
    res["device"] = desc
    _write(out, res)
    print(json.dumps({s: {k: res["seeds"][s][k] for k in ("generations", "first", "final", "max")}
                      for s in res["seeds"]}))
    print(json.dumps({"no_drift_all_seeds": res["no_drift_all_seeds"]}))

    if os.path.exists(args.long_run):
        with open(args.long_run) as f:
            v = json.load(f)
        lart = {
            "workload": "Humanoid-v5 at the reference design point population "
                        "(pop 1000; configurations/humanoid.json:1-36 uses "
                        "episodes_per_batch 1000) — per-gen checkpointed (resume_dir)",
            "generations": len(v["curve"]),
            "curve": v["curve"], "eval_curve": v.get("eval_curve"),
            "ep_len": v.get("ep_len"),
            "first": v["curve"][0], "final": v["curve"][-1], "max": max(v["curve"]),
            "drift": _drift(v["curve"]),
            "device": desc,
        }
        _write(long_out, lart)
        print(json.dumps({"pop1000_gens": lart["generations"], "final": lart["final"], "max": lart["max"]}))
    return res


if __name__ == "__main__":
    main()
