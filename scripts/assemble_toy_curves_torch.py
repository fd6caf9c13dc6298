"""Assemble the PyTorch port's ToyCatch learning-campaign artifacts.

The port's counterpart of scripts/assemble_toy_curves.py. It reads the
per-generation metrics.jsonl (and log.txt) that
``python -m deep_neuroevolution_torch.main train --log_dir DIR`` wrote for
the ES campaign (configurations/es_toy_learn.json: the VBN small DQN, the
CPU-stack schema with eval_prob and the adaptive cutoff) and the GA
campaign (configurations/ga_toy_learn.json: the LargeDQN and the
validation and test ladder) on the port's ToyCatch engine, and writes one
curve artifact per campaign, with the JAX artifact's keys plus ``device``
(the card and the host it is assembled on: run it on the machine that
ran the campaign):

    results/toy_es_campaign_torch → results/toy_es_curve_torch.json
    results/toy_ga_campaign_torch → results/toy_ga_curve_torch.json

Chance level: ToyCatch random play catches a drop with p ≈ paddle width /
reachable span; a random policy's EpRewMean reads ≈ 0.4-0.5 (the first
generations of the campaigns themselves).

Run: python scripts/assemble_toy_curves_torch.py [es|ga|both] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.utils import machine  # noqa: E402

ES_LOG, ES_OUT = "results/toy_es_campaign_torch", "results/toy_es_curve_torch.json"
GA_LOG, GA_OUT = "results/toy_ga_campaign_torch", "results/toy_ga_curve_torch.json"


def load(log_dir):
    """Rows of metrics.jsonl, one a generation, in order: from the LAST
    first-generation row onward (a crashed launch appends its partial
    generations to the same file, and a restart, not a resume, begins
    again at the first generation), the LAST row of each generation (a
    resumed run restarts from its last snapshot and logs the generations
    after it again).

    A generation is numbered by its ``Iteration``, which the GA logs. The
    ES trainer logs none, in either package; its rows are numbered by
    ``EpisodesSoFar``, whose first generation's value is its
    ``EpisodesThisIter`` and which a resumed run repeats. (The JAX script's
    ``load`` keys every ES row by a missing Iteration, so that an ES log
    comes back as its last row alone.)"""
    path = os.path.join(REPO, log_dir, "metrics.jsonl")
    rows = [json.loads(ln) for ln in open(path)]
    if any("Iteration" in r for r in rows) or not rows:
        def gen(r):
            return r.get("Iteration")
        first = [i for i, r in enumerate(rows) if gen(r) == 1]
    else:
        def gen(r):
            return r.get("EpisodesSoFar")
        first = [i for i, r in enumerate(rows) if gen(r) == r.get("EpisodesThisIter")]
    rows = rows[first[-1]:] if first else rows
    by_gen = {}
    for r in rows:
        by_gen[gen(r)] = r
    return [by_gen[k] for k in sorted(by_gen)]


def cutoff_bumps(log_dir):
    """The adaptive cutoff's bumps from log.txt ('Increased timestep limit
    from X to Y' lines, es.py:113-116)."""
    path = os.path.join(REPO, log_dir, "log.txt")
    bumps = []
    if os.path.exists(path):
        for ln in open(path):
            if "Increased timestep limit" in ln:
                bumps.append(ln.split("]")[-1].strip())
    return bumps


def significance(first5, last5, stds, n_eps):
    """(last5 − first5) in units of the SEM of a 5-generation window mean:
    per-generation SEM = EpRewStd / √episodes, window SEM = that / √5."""
    s = sum(stds) / max(len(stds), 1)
    sem = s / math.sqrt(max(n_eps, 1)) / math.sqrt(5)
    return (last5 - first5) / max(sem, 1e-9)


def assemble_es(out=ES_OUT, log_dir=ES_LOG, device=None):
    rows = load(log_dir)
    curve = [r.get("EpRewMean") for r in rows]
    ev = [r.get("EvalEpRewMean") for r in rows]
    base = sum(curve[:5]) / max(len(curve[:5]), 1)
    last5 = sum(curve[-5:]) / max(len(curve[-5:]), 1)
    sig = significance(base, last5, [r.get("EpRewStd", 0.0) for r in rows], rows[0].get("EpisodesThisIter", 256))
    art = {
        "workload": "ES on the port's native ToyCatch engine (64 slots) through deep_neuroevolution_torch.main "
                    "train (configurations/es_toy_learn.json): ModelVirtualBN small DQN on the split route "
                    "(the fc on kernel K1 at B=32, the engine's two pipeline groups), the gradient on K2 "
                    "(128 pairs), pop 256 in rounds of 32 pairs, eval_prob->8 evals/gen, adaptive cutoff DSL "
                    "active, on one CUDA card (see device)",
        "generations": len(rows),
        "train_reward": curve,
        "eval_reward": ev,
        "ep_len": [r.get("EpLenMean") for r in rows],
        "eval_pop_rank": [r.get("EvalPopRank") for r in rows],
        "tslimit": [r.get("TimestepLimitPerEpisode") for r in rows],
        "cutoff_bumps": cutoff_bumps(log_dir),
        "s_per_gen": [r.get("TimeElapsedThisIter") for r in rows],
        "random_baseline_first5": base,
        "final_mean_last5": last5,
        "best_eval": max((x for x in ev if x == x), default=float("nan")),
        "improvement_sigma": sig,  # the window means' difference over its SEM
        "clearly_above_chance": last5 > 3 * max(base, 0.2) or sig > 5.0,
        "device": machine.describe(resolve_device(device)),
    }
    with open(os.path.join(REPO, out), "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({k: art[k] for k in (
        "generations", "random_baseline_first5", "final_mean_last5",
        "best_eval", "improvement_sigma", "clearly_above_chance")}))
    return art


def assemble_ga(out=GA_OUT, log_dir=GA_LOG, device=None):
    rows = load(log_dir)
    pop_mean = [r.get("PopulationEpRewMean") for r in rows]
    pop_max = [r.get("PopulationEpRewMax") for r in rows]
    trunc = [r.get("TruncatedPopulationRewMean") for r in rows]
    test = [r.get("TruncatedPopulationEliteTestRewMean") for r in rows]
    base = sum(pop_mean[:5]) / max(len(pop_mean[:5]), 1)
    last5 = sum(pop_mean[-5:]) / max(len(pop_mean[-5:]), 1)
    # the GA logs no per-generation reward std: √mean (at least √0.25) as a
    # conservative per-episode std for the significance measure
    sig = significance(base, last5, [max(m, 0.25) ** 0.5 for m in pop_mean], rows[0].get("PopulationEpCount", 256))
    art = {
        "workload": "GA on the port's native ToyCatch engine (64 slots) through deep_neuroevolution_torch.main "
                    "train (configurations/ga_toy_learn.json): LargeDQN on the whole-net kernel K3 (B=32, the "
                    "engine's two pipeline groups), pop 256, truncation 20, validation ladder 10x4 + elite "
                    "test 8, adaptive cutoff, on one CUDA card (see device)",
        "generations": len(rows),
        "pop_reward_mean": pop_mean,
        "pop_reward_max": pop_max,
        "truncated_parent_mean": trunc,
        "elite_test_reward": test,
        "tslimit": [r.get("TimestepLimitPerEpisode") for r in rows],
        "cutoff_bumps": cutoff_bumps(log_dir),
        "s_per_gen": [r.get("TimeElapsedThisIter") for r in rows],
        "random_baseline_first5": base,
        "final_mean_last5": last5,
        "improvement_sigma": sig,
        "clearly_above_chance": last5 > 3 * max(base, 0.2) or sig > 5.0,
        "device": machine.describe(resolve_device(device)),
    }
    with open(os.path.join(REPO, out), "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({k: art[k] for k in (
        "generations", "random_baseline_first5", "final_mean_last5",
        "improvement_sigma", "clearly_above_chance")}))
    return art


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="?", choices=["es", "ga", "both"], default="both")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu: where the campaign ran")
    args = ap.parse_args()
    if args.which in ("es", "both"):
        assemble_es(device=args.device)
    if args.which in ("ga", "both"):
        assemble_ga(device=args.device)
