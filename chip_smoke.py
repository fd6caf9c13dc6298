#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deep_neuroevolution_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA device, nvcc and
g++. Phases, each printing its name when it starts and its seconds when it
ends:

1. device and build: the card's name and power limit; nvcc builds the
   kernels and g++ the host engine, side by side;
2. kernel K1 (population_linear) against its plain PyTorch version, float32
   and bfloat16, at the population fc's shapes (B=256, 128, the eval
   episodes' 4 and NS-ES's mean-BC episodes' 1), each on the bulk variant,
   beside one ``torch.bmm``;
3. kernel K2 (noise_gradient) against its plain version at the main
   path's shape (256 pairs on a 25M-float table) and at 2500 and 256 pairs
   on the reference's 250M-float table, with unaligned offsets and one
   slice that ends at the table's last element; then, through its C entry
   point, a bit-for-bit repeat and its time back-to-back and in a CUDA
   graph, beside its bound, an L2 floor (B·D·4 bytes over the L2 read
   rate that a probe measures in the same phase) and, where it reads the
   table's slices as a view, one ``F.embedding_bag`` call;
4. one ES generation of configurations/es_atari_config.json through the
   port's CLI (``main train``) on the ToyCatch engine at the model's full
   width, with the population, cutoff and noise table cut to smoke size.
   Both kernels' launch counters must move, and a small forward on the card
   must agree with the same forward on the CPU;
5. kernel K3 (large_dqn_fused_scores, the LargeDQN's whole-net forward)
   against its plain version at B=128 and 256, 4 and 18 actions, and
   against a second launch of itself (bit for bit), timed back-to-back and
   in a CUDA graph after a warm-up, beside the split route's time;
6. kernel K5 (dqn_conv_chain_fused) against its plain version, SmallDQN and
   LargeDQN geometries, float32 and bfloat16, timed back-to-back and in a
   CUDA graph beside the batched-product conv chain's time, and at B=1
   and 7; and K1 at the LargeDQN's fc shape;
7. two GA generations of configurations/ga_atari_config.json (LargeDQN)
   through ``main train`` on the ToyCatch engine at full width, the
   population, cutoff and noise table cut to smoke size: K3's counter must
   move, every chain of generation 2 be of length 2 (but the elite carried
   over), and a small forward on the card match the CPU's plain K3; then
   K3 is timed (in a CUDA graph) at each batch size the two generations
   launched it with, for its launches × time by batch size;
8. one random-search generation of configurations/rs_atari_config.json
   (SmallDQN) through the Python API with ``conv_impl='fused'``: the K5
   and K1 counters must move; then K5 is timed (in a CUDA graph) at each
   batch size the generation launched it with;
9. kernels K4 (vbn_dqn_fused1_scores) and K6 (vbn_dqn_fused_scores), the
   VBN-DQN's whole-net forwards, against their plain versions at B=1, 4,
   8, 128 and 256 (each member split over several blocks at B ≤ 44, the
   persistent grid above), 4 and 18 actions, and against a second launch
   of themselves (bit for bit), timed back-to-back and in a CUDA graph
   beside the split route's time (convs, K1 and the out layer) in float32
   and bfloat16; and on the all-ties case (every x1 value, and K6's x2,
   next to a bf16 rounding midpoint) against the sequential chains;
10. one ES generation of configurations/es_atari_config.json at phase 4's
   cut through the Python API with ``forward_impl='fused1'``: K4's counter
   must move, the 8 eval episodes run, and a small forward on the card (K4)
   must agree with the CPU's plain K4; then K4 is checked and timed (in a
   CUDA graph) at each batch size the generation launched it with;
11. the same with ``forward_impl='fused'`` and K6;
12. the same with ``forward_impl='split'`` (K1), so that the three routes'
   generations are timed alike, each after a warm-up of the process.
   Each of phases 10-12 also times its trainer's eval episodes alone;
13. the reference's 250M-float noise table, built once for phases 14-15;
14. one ES generation of configurations/maze_es.json (Hard Maze,
   ContinuousMLP) at its full size, through the Python API: population
   512, 400 steps, 8 eval episodes. K2's counter must move, every return
   lie in [−(the maze's diagonal), 0], a whole episode of 8 members
   recorded on the card match the CPU's observe, forward and step, step by
   step (teacher-forced), and the generation's rollout through CUDA graphs
   repeat the eager loop bit for bit (both timed); then K2 is checked and
   timed on the generation's own offsets and weights (256 pairs, D = 498);
15. the same for configurations/es_gym_config.json (CartPole,
   SimpleClassifier): population 5000, cutoff 5000, graphs against eager;
   K2 at 2500 pairs, D = 386;
16. three NS-ES iterations of configurations/maze_nses.json whole (256
   episodes, M = 3 parents, k = 10, novelty_prob) on phase 13's table,
   through the Python API: each iteration's novelty of its 256 BCs,
   computed on the card, must equal the CPU's plain computation against
   the same archive snapshot within rtol 1e-6; K2 launches once an
   iteration and each g matches its plain version; the archive holds
   3 + 3 points; every parent's θ stays finite. Seconds and env steps/s
   per iteration; K2 timed on the last iteration's offsets (128 × 498);
17. two iterations each of configurations/frostbite_nses.json and
   frostbite_nsres.json through the loader (Frostbite → ToyCatch with
   EpisodicLife, 256 slots, the VBN-DQN at full width, the per-step RAM
   trajectory BC): K1 must launch at B=128 (the pipeline groups) and B=1
   (the parents' mean-BC episodes), K2 once an iteration (50 or 128 pairs
   × 1,004,852), each g against its plain version; a small forward on the
   card matches the CPU's; each rollout's novelty equals a float64 plain
   recomputation from its trajectory. Frames/s and the seconds of the
   trajectory novelty per iteration; K2 timed on the last iteration's
   offsets. Nothing is cut but the game;
18. one generation of configurations/frostbite_es.json through the loader,
   nothing cut but the game (Frostbite → ToyCatch with EpisodicLife, 256
   slots, the VBN-DQN at full width, phase 13's table), in quota mode:
   rounds of 64 pairs until 5000 episodes and 10,000 steps are both met.
   The round count must equal the JAX package's rule, 50 eval episodes run
   (eval_prob 0.01 × 5000), K1 and K2 launch, a small forward on the card
   match the CPU's and K2's g on the generation's own offsets its plain
   version. Seconds, frames/s, and K2 timed at that shape (about 2560
   pairs × 1,004,852);
19. long runs on the card: ``main train --log_dir --snapshot_freq 1`` on
   phase 4's cut of es_atari_config.json and on maze_nses.json (the table
   cut to 25M floats), 3 generations straight through against 2 and a
   resumed 1: θ and the last generation's returns and lengths must be
   equal bit for bit, and the straight run's policy file must load back to
   its θ; phase 4's cut with ``mirror_crn`` and σ = 0 (a pair's θ halves
   equal): each pair's returns and lengths equal; one quota-mode
   generation of maze_es.json (1024 episodes, 300,000 steps) meets both
   quotas;
20. three GA generations of configurations/frostbite_ga.json through the
   loader with ``algo='ga'``, nothing cut but the game (Frostbite →
   ToyCatch with EpisodicLife, 256 slots, SmallDQN at full width, CPU-style
   chains, population 10, phase 13's table): K1 must launch, the chains be
   bare indices of length 3 by the third generation, every cached parent's
   θ equal its chain rebuilt whole by ``theta_from_seed_chain(..., 'cpu')``
   within 1e-6, and the elite's forward on the card (K1) the CPU's. Seconds
   and frames/s a generation, K1's launches by batch size;
21. the GA and RS on the device arm through the loader, on phase 13's
   table: configurations/es_gym_config.json whole as a GA (CartPole,
   population 5000, cutoff 5000, GPU-style chains, the 10 × 30 + 200
   ladder), configurations/maze_es.json as a GA (CPU-style chains, 512
   members, 400 steps, two generations) and as RS (one), and the maze GA
   with ``eval_batch`` 128 (four rounds). Seconds, env steps/s and rounds
   a generation. The first fitness pass of the CartPole and maze GAs
   replayed on the CPU from the card's draws and reset states (free-running
   agreement, a reading), and its first round teacher-forced: every step's
   observation, state and reward on the card within 1e-5 / 1e-4 of the
   CPU's, no action apart but at a near tie;
22. phase 4's cut of configurations/es_atari_config.json on each host
   engine ``obs_mode`` ('gray', 'indexed', 'preproc'), one trainer a mode:
   a warm-up generation each, then two timed ones each, in turns (gray,
   indexed, preproc, preproc, indexed, gray): seconds, frames/s and bytes
   uploaded a slot-step (every frame upload counted); K1 and K2 must
   launch in each; the card's preprocessing of each mode's engine frames
   against the CPU's ('preproc' bit for bit, the others within 1e-6);
23. the threefry noise sources: VirtualNoise rows on the card against the
   CPU's (the words equal, the normals within 1e-6); the 250M-float
   ``noise: device`` table built on the card (its seconds beside phase
   13's host build); the VirtualNoise gradient at 256 and 2560 pairs ×
   1,004,852 (8 pairs against the CPU within 1e-5·max|g|); phase 4's cut
   on ``noise: virtual`` (K1 launches, K2 none) and on ``noise: device``
   (K2 once a generation, the first generation's call against its plain
   version on the same table, offsets and weights), two generations each;
   maze_es.json as a GA on
   ``noise: virtual``: every cached θ against its whole chain within 1e-6;
24. the DQN family's other fields at B=128 on ToyCatch frames: a tanh
   SmallDQN, an elu VirtualBNDQN, a tanh LargeDQN and a BNDQN, card
   against CPU within phase 4's tolerance, each on the split route (K1
   launching, K3/K4/K5/K6 not; BNDQN no kernel); a forced fused route on
   tanh raises; ``prepare_batch_params_chunked`` at LargeDQN B=256, chunk
   64, against the whole prepare bit for bit, float32 and bfloat16, with
   both peak memories;
25. ``main replay``: phase 4's policy file, 8 episodes on 8 engine slots
   (K1 launches; teacher-forced against the CPU, the returns the CPU's
   for the same engine episode seeds but at a near tie); a GPU-style
   LargeDQN chain on a 25M-float table (K3 launches; every K3 forward
   teacher-forced against the CPU's plain K3 within 1e-3·max|score|, the
   argmax equal but at a near tie; K3 at the replay's batch sizes against
   its plain version on the card, and timed); phase 14's maze
   policy through ``rollout_batch_scan`` (teacher-forced on the CPU, the
   trajectories within 1e-3, the .npz keys the CPU's);
26. scale-out, a torch.distributed world of one rank on NCCL: one
   generation of configurations/maze_es.json at full size (512 members,
   400 steps, the 250M table, built again) through ``PodESTrainer`` (the
   loader's ``pod: true``) and through ``ESTrainer``, the same seed, two
   generations each in turns (pod, single, single, pod): returns, lengths
   and BCs equal bit for bit, θ within 1e-6; K2 once a generation in each;
   then the GA on the maze (``algo: ga``) the same way. Seconds of each
   arm's generations, and of the collectives;
27. two ranks that share the card over gloo, two child processes of this
   script (``--pod-rank``) on phase 1's kernel library: the device pods
   (maze_es.json, maze_nses.json) and the host pods (phase 4's cut of
   es_atari_config.json, ga_atari_config.json at 256 members and cutoff
   200, frostbite_nses.json; each table cut to 25M floats) a few
   generations each, every rank's outputs against the same case's
   two-rank emulation in this process, bit for bit, and the maze ES pod
   against the single trainer whose rounds are its blocks (returns bit for
   bit, θ within 1e-6); K1, K2 and K3 must launch in each rank on their
   cases; a ``main train --log_dir`` of maze_es.json in the two ranks,
   where only rank 0 may write. Seconds a generation per rank and arm, and
   the share of it in collectives;
28. the vector host engine at the Humanoid's width: one generation of
   configurations/humanoid.json as it stands through the loader (quota
   mode: rounds of 32 pairs on 64 slots until 1000 episodes and 100,000
   steps, σ 0.02, calc_obstat_prob 0.01, 30 eval episodes, the env's
   1000-step cap) on its own table (the reference stream's first 25M
   floats), through ``rollout_host`` → ``rollout_host_vec``. The physics is
   MuJoCo's Humanoid-v5 where gymnasium and mujoco import, else
   ``StandInHumanoid`` (defined here and nowhere in the package: the
   Humanoid's widths, seeded numpy dynamics, not physics); the phase's
   lines say which ("physics"). K2 must launch once and agree with its
   plain version on the generation's offsets and weights (timed
   back-to-back and in a CUDA graph); a round's first steps' actions, for
   8 members, must agree with the CPU's forward on the same θ, obs stats
   and observations; the obs stat after the update must be the CPU's
   increment of the same sums. Seconds, env steps/s, and the seconds of
   the vector rollout's upload, forward and engine step (synced around
   each); the card's name and power limit;
29. two iterations of configurations/humanoid_nses.json through the loader
   (M = 3, k = 10, novelty_prob, the final mass centre as the BC) with its
   1000 episodes in one round of 1000 slots, on phase 28's engine and
   table: K2 once an iteration, against its plain version; the archive
   grows from 3 to 5. Seconds and env steps/s an iteration;
30. native extras: the engine's ALE backend built against the ALE API stub
   (``native.build.build_ale_stub``; a scripted counter game, not ALE) and
   the stress binary without TSAN, side by side with g++; 256 stub slots
   stepped 100 times (4 actions, 128 RAM bytes, (2, 210, 160) frames,
   rewards, finished slots reset), their emulator frames per second,
   EpisodicLife through lives(); the stress binary prints ``stress ok``;
31. the inspector on the card, on a 25M-float table of its own (the
   reference stream's first 25M floats; phase 13's table is freed by
   then): two ES generations of es_atari_config.json at phase 4's cut with
   ``vine_snapshot_dir`` set through the Python API (K1 and K2 must
   launch; K2 once a generation); ``load_data`` reads both generations
   back (2 × pairs offspring rows, each column what the trainer handed the
   dump); ``process_bc`` 'two_end', then 'pca' on the card against the
   same reduction on the CPU within 1e-9·max (float64), both reduced
   directories read back, and 'tsne' raising its ImportError where
   scikit-learn does not import; ``replay_point`` on the card (ToyCatch)
   for generation 2's parent point and a +1 and a −1 offspring row: θ'
   bit for bit the CPU's, each replay repeated bit for bit, K1 launching,
   every recorded forward teacher-forced against the CPU on its first 4
   slots (slot 0 is the replayed episode), the replayed
   return printed beside the fitness the row records; then the same on
   two full-size maze_es.json generations (K2 once each; the replays'
   trajectories ``[400, 1, 2]``, teacher-forced over their 400 steps).
   Where matplotlib does not import the phase says that the GUI and
   plot.py were not run (an import-spec check);
32. the learning campaigns' scripts at a smoke cut, each through its
   ``main`` into a temporary directory: scripts/run_maze_comparison_torch.py
   (10 ES generations of 512 members, 10 NS-ES iterations of 256, an eval
   every 5; K2 once a generation at 256 and 128 × 498), the ES parent's
   last eval teacher-forced against the CPU over its 400 steps as in phase
   14; scripts/parity_study_torch.py (1 seed × 3 generations per arm on the
   maze with MujocoMLP 32×32, K2 at 128 × 1506, and the eval bit-identity
   check, which must hold); configurations/es_toy_learn.json and
   ga_toy_learn.json for 2 generations each through ``main train --log_dir``
   (only the table cut, to 25M floats; K1 must launch at B=32 and K2 once a
   generation in the ES, K3 at B=32 in the GA), then
   scripts/assemble_toy_curves_torch.py on both logs. Each artifact's keys
   must be the committed JAX artifact's plus ``device``; K2 at each
   campaign shape and K3 at each B the toy GA launched it with are checked
   against their plain versions and timed (K3 with its bound); then K1 at
   B=32 and 8 against its plain version, timed beside ``torch.bmm`` and its
   bound.

Every failure raises and the script exits non-zero without its last line.
On success the line before the last is a JSON object with each kernel's
numbers, and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# phase 4's cut of es_atari_config.json (population 5000, cutoff 5000,
# a 250M-float table); the model's widths are not cut
SMOKE_OVERRIDES = {
    "game": "toy",  # the engine has no ALE: ToyCatch stands in for frostbite
    "population_size": 512,  # 256 pairs: two rounds of 256 engine slots
    "episode_cutoff_mode": 200,
    "noise_size": 25_000_000,
    "env_kwargs": {"batch_size": 256},
}

# phase 7's cut of ga_atari_config.json (population 1000, cutoff 5000, a
# 250M-float table, frostbite); the LargeDQN's widths are not cut, and the
# validation and test ladder keeps the config's sizes (10 × 30, 200)
GA_OVERRIDES = {
    "game": "toy",
    "population_size": 512,  # two fitness rounds of 256 engine slots
    "episode_cutoff_mode": 200,
    "noise_size": 25_000_000,
    "env_kwargs": {"batch_size": 256},
    "theta_hbm_budget": 8 * 2**30,  # 256 LargeDQN members (4.1 GB of f32 θ) per round
}
# K3 at B=128, what each of the GA's two pipeline groups of 256 slots gives
# it, and B=256, one group of 256; K5 at B=128 (SmallDQN f32, the RS
# phase's per-group shape), at B=256 for both geometries and types, and at
# B=1 and 7 (a persistent block with few members) for SmallDQN f32 and
# LargeDQN bf16
K3_BATCHES = (128, 256)
K5_CASES = (("SmallDQN", "float32", 128), ("SmallDQN", "float32", 256), ("SmallDQN", "bfloat16", 256),
            ("LargeDQN", "float32", 256), ("LargeDQN", "bfloat16", 256), ("SmallDQN", "float32", 1),
            ("SmallDQN", "float32", 7), ("LargeDQN", "bfloat16", 1), ("LargeDQN", "bfloat16", 7))
# phase 8's cut of rs_atari_config.json (population 1000, cutoff 5000)
RS_CUT = {"population_size": 256, "episode_cutoff_mode": 200, "noise_size": 25_000_000, "batch_size": 256}
# K4 and K6 at B=4 (an eval-episode group), 128 (one of an ES round's two
# pipeline groups) and 256, and at B=1 and 8
VBN_BATCHES = (1, 4, 8, 128, 256)
# the VBN-DQN's whole-net kernels: forward_impl → (kernel, its plain version's name)
VBN_ROUTES = {"fused1": ("vbn_dqn_fused1_scores", "vbn_dqn_fused1_scores_plain"),
              "fused": ("vbn_dqn_fused_scores", "vbn_dqn_fused_scores_plain")}


class Phase:
    """Prints a phase's name on entry and its seconds on exit."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== phase {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        status = "failed" if exc[0] else "done"
        print(f"== phase {self.name} {status} in {self.seconds:.2f} s", flush=True)
        return False


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops, dtype: str = None):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type; ``ops`` is a count of
    ``dtype`` operations or a dict dtype → count."""
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = sum(n / PEAK_FLOPS[d] for d, n in ops.items())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def build_all() -> None:
    """nvcc for the kernels and g++ for the engine, started together."""
    from deep_neuroevolution_torch.native import build as engine_build
    from deep_neuroevolution_torch.ops import _cuda_build

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {
            "kernels": pool.submit(_cuda_build.build),
            "engine": pool.submit(engine_build.ensure_built),
        }
        for name, fut in futs.items():
            print(f"built {name}: {fut.result().relative_to(ROOT)}", flush=True)
    _cuda_build.load()


def warm(fn, seconds: float = 1.0) -> None:
    """Calls ``fn`` until ``seconds`` of the card's work have passed: the
    first of a phase's timings after a spell of light load read up to 12%
    slow on an H100 (K1 at the LargeDQN fc, timed right after the K3 and K5
    phases), and 0.2 s of warm-up did not always cure it."""
    import torch

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Milliseconds per call with the host's launch cost left out: ``calls``
    calls captured in one CUDA graph, replayed ``replays`` times between
    two CUDA events. Where a call's host cost exceeds its device time
    (small shapes), ``cuda_ms`` measures the host and this the device."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture, as torch.cuda.graph asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


# K1 at the VBN-DQN's fc: B=256 is its shape with one group of 256 slots;
# B=128 is what each of the ES generation's two pipeline groups gives it;
# B=4 is an eval-episode group's (8 slots, two groups); B=1 a mean-BC
# episode's of NS-ES on the host engine
K1_CASES = ((256, 3872, 256, "float32"), (256, 3872, 256, "bfloat16"), (128, 3872, 256, "float32"),
            (4, 3872, 256, "float32"), (1, 3872, 256, "float32"))


def check_population_linear(device, cases=K1_CASES) -> dict:
    """K1 against its plain version at each (B, K, N, dtype) of ``cases``,
    each on the bulk variant (its counter must move); returns the first
    case's numbers."""
    import torch

    from deep_neuroevolution_torch.ops import population_linear as k1

    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    for B, K, N, name in cases:
        dtype = getattr(torch, name)
        x = torch.rand((B, K), generator=gen, device=device).to(dtype)
        W = torch.randn((B, K, N), generator=gen, device=device).to(dtype)
        p = k1.plan_for(x, W)
        bulk = k1.population_linear.bulk_launches
        y = k1.population_linear(x, W)
        require(k1.population_linear.bulk_launches == bulk + 1,
                f"population_linear B={B} {name} did not take the bulk variant ({p.variant}: {p.reason})")
        ref = k1.population_linear_plain(x, W)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())  # float32 sums in another order
        require(bool(torch.isfinite(y).all()), "population_linear returned non-finite values")
        require(err <= tol, f"population_linear B={B} {dtype}: max abs err {err} > {tol}")
        warm(lambda: k1.population_linear(x, W))
        ms = cuda_ms(lambda: k1.population_linear(x, W), 20)
        plain_ms = cuda_ms(lambda: k1.population_linear_plain(x, W), 10)
        library_ms = cuda_ms(lambda: torch.bmm(x[:, None, :], W), 20)
        s = x.element_size()
        bound_ms, bound_by = bound(B * K * N * s + B * K * s + B * N * 4, 2 * B * K * N, name)
        blocks_per_sm = k1.bulk_blocks_per_sm(dtype, p.smem_bytes)
        require(blocks_per_sm >= k1.BLOCKS_PER_SM, f"the plan counts on {k1.BLOCKS_PER_SM} blocks an SM, "
                f"the card fits {blocks_per_sm}")
        row = dict(B=B, K=K, N=N, dtype=name, variant=p.variant, grid=p.grid, rows=p.rows, stages=p.stages,
                   blocks_per_sm=blocks_per_sm, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_over_ms=bound_ms / ms, ms_over_library=ms / library_ms,
                   graph_ms=graph_ms(lambda: k1.population_linear(x, W)),
                   library_graph_ms=graph_ms(lambda: torch.bmm(x[:, None, :], W)))
        print("population_linear " + json.dumps(row), flush=True)
        out.append(row)
        del x, W, y, ref
    return out[0]


def union_bytes(idx, dim: int) -> int:
    """Bytes of the table that the slices [idx, idx + dim) cover together."""
    covered, end = 0, -1
    for s in sorted(int(i) for i in idx):
        if s + dim > end:
            covered += s + dim - max(s, end)
            end = s + dim
    return covered * 4


def l2_read_rate(device, mbytes: int = 24, reps: int = 40) -> dict:
    """The rate at which L2 delivers bytes to the SMs: four blocks an SM read
    a buffer of ``mbytes`` MB (it fits the 50 MB L2) ``reps`` times over
    with 16-byte loads that bypass L1 (csrc/noise_gradient.cu
    ``nevo_l2_read_probe``), timed by CUDA events after a warm-up."""
    import torch

    from deep_neuroevolution_torch.ops import _cuda_build

    lib = _cuda_build.load()
    n16 = mbytes * 2**20 // 16
    buf = torch.ones(n16 * 4, device=device)
    grid = 4 * torch.cuda.get_device_properties(device).multi_processor_count
    out = torch.empty(grid * 512, device=device)
    stream = _cuda_build.current_stream(device)

    def call():
        err = lib.nevo_l2_read_probe(buf.data_ptr(), n16, reps, grid, out.data_ptr(), stream)
        _cuda_build.check(lib, err, "nevo_l2_read_probe")

    warm(call, 0.3)
    ms = cuda_ms(call, 10)
    require(float(out.sum()) > 0, "the L2 probe read nothing")
    return dict(buffer_mb=mbytes, reps=reps, ms=ms, bytes_per_s=n16 * 16 * reps / ms * 1e3)


def embedding_bag_ms(table, idx, w, dim: int, ref) -> tuple:
    """(ms, note): ``F.embedding_bag`` with ``per_sample_weights`` over the
    table's every slice, ``table.unfold(0, dim, 1)`` (a view, no copy),
    computes g in one call if the library reads the view as it stands. The
    call is timed only if it agrees with ``ref`` and its scratch memory
    stays under a quarter of the B slices' bytes (a copy of the slices
    would take all of them); else ms is None and note says why."""
    import torch
    import torch.nn.functional as F

    def call():
        return F.embedding_bag(idx[None].long(), table.unfold(0, dim, 1), mode="sum", per_sample_weights=w[None])[0]

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        g = call()
        torch.cuda.synchronize()
    except (RuntimeError, torch.cuda.OutOfMemoryError) as e:  # the library copies the view
        torch.cuda.empty_cache()
        return None, f"refused: {str(e).splitlines()[0][:160]}"
    extra = torch.cuda.max_memory_allocated() - base
    err = float((g - ref).abs().max())
    if extra > idx.shape[0] * dim * 4 // 4 or err > 1e-5 * float(ref.abs().max()):
        return None, f"ran with {extra} bytes of scratch and max abs err {err}"
    return cuda_ms(call, 5), f"one call, {extra} bytes of scratch"


# K2 at es_atari_config.json's 2500 pairs and at 256 pairs on the
# reference's 250M-float table, and at the main path's own shape, phase 4's
# 256 pairs on its 25M-float table
K2_CASES = ((256, 25_000_000), (2500, 250_000_000), (256, 250_000_000))


def k2_case(device, table, idx, w, dim: int, l2_bytes_per_s: float) -> dict:
    """K2 on one (table, offsets, weights): once through the wrapper against
    its plain version (within 1e-5·max|g|: float32 sums in another order),
    then through the C entry point (the wrapper's range check syncs the
    host), which must repeat the wrapper's g bit for bit, timed back-to-back
    and in a CUDA graph, beside the plain version, its bound, the L2 floor
    and one ``F.embedding_bag`` call."""
    import torch

    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain

    lib = _cuda_build.load()
    B, count = idx.shape[0], table.shape[0]
    g = noise_gradient(table, idx, w, dim)
    ref = noise_gradient_plain(table, idx, w, dim)
    torch.cuda.synchronize()
    err = float((g - ref).abs().max())
    tol = 1e-5 * float(ref.abs().max())  # float32 sums in another order
    require(bool(torch.isfinite(g).all()), "noise_gradient returned non-finite values")
    require(err <= tol, f"noise_gradient B={B} D={dim} table={count}: max abs err {err} > {tol}")
    out = torch.empty_like(g)

    def entry():
        e = lib.nevo_noise_gradient(table.data_ptr(), idx.data_ptr(), w.data_ptr(), B, dim, out.data_ptr(),
                                    _cuda_build.current_stream(device))  # graph_ms captures on a side stream
        _cuda_build.check(lib, e, "nevo_noise_gradient")

    entry()
    torch.cuda.synchronize()
    require(torch.equal(out, g), f"noise_gradient B={B} D={dim} table={count}: a second launch differs")
    warm(entry)
    ms = cuda_ms(entry, 20)
    # least bytes: the table elements the slices cover, read once, plus
    # the offsets, the weights and g
    nbytes = union_bytes(idx.cpu(), dim) + B * 8 + dim * 4
    bound_ms, bound_by = bound(nbytes, 2 * B * dim, "float32")
    library_ms, library_note = embedding_bag_ms(table, idx, w, dim, ref)
    row = dict(B=B, D=dim, table=count, max_abs_err=err, tol=tol, ms=ms, graph_ms=graph_ms(entry),
               wrapper_ms=cuda_ms(lambda: noise_gradient(table, idx, w, dim), 5),
               plain_ms=cuda_ms(lambda: noise_gradient_plain(table, idx, w, dim), 3, warmup=1),
               library_ms=library_ms, library_note=library_note, bound_ms=bound_ms, bound_by=bound_by,
               l2_floor_ms=B * dim * 4 / l2_bytes_per_s * 1e3,
               streamed_slices_ms=B * dim * 4 / PEAK_BYTES_PER_S * 1e3)
    print("noise_gradient " + json.dumps(row), flush=True)
    return row


def check_noise_gradient(device, dim: int) -> dict:
    """K2 at each (pairs, table) of ``K2_CASES`` (``k2_case``), offsets
    uniform with one slice that ends at the table's last element and an odd
    one. Returns the main path's shape's numbers, the others under
    ``other_shapes``, and the L2 probe's rate."""
    import torch

    l2 = l2_read_rate(device)
    print("l2_probe " + json.dumps(l2), flush=True)
    gen = torch.Generator(device=device).manual_seed(2)
    big = torch.randn(max(n for _, n in K2_CASES), generator=gen, device=device)  # drawn on the card
    rows = []
    for B, count in K2_CASES:
        table = big[:count]  # a view: the first `count` floats
        idx = torch.randint(0, count - dim + 1, (B,), generator=gen, device=device, dtype=torch.int32)
        idx[0] = count - dim  # this slice ends at table[count - 1]
        idx[1] = 1  # unaligned
        w = torch.randn(B, generator=gen, device=device)
        rows.append(k2_case(device, table, idx, w, dim, l2["bytes_per_s"]))
    del big
    return dict(rows[0], l2_bytes_per_s=l2["bytes_per_s"], other_shapes=rows[1:])


def run_generation(device) -> dict:
    """One ES generation through the CLI; returns what the checks need."""
    import torch

    from deep_neuroevolution_torch import main as cli
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
    from deep_neuroevolution_torch.ops.population_linear import population_linear

    argv = [
        "train", "--exp_file", str(ROOT / "configurations" / "es_atari_config.json"),
        "--iterations", "1", "--overrides", json.dumps(SMOKE_OVERRIDES), "--device", str(device),
    ]
    print("main " + " ".join(argv), flush=True)
    zero_counters()
    t0 = time.perf_counter()
    trainer = cli.cmd_train(cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    print("launches " + json.dumps(launches), flush=True)
    for name in (population_linear.__name__, noise_gradient.__name__):
        require(launches[name] > 0, f"the main path never launched {name}")
    require(launches["population_linear.bulk"] == launches["population_linear"],
            "the main path launched population_linear's general variant")
    return dict(trainer=trainer, seconds=seconds, launches=launches)


def small_forward(tr, thetas, obs, device):
    """Scores of ``thetas`` on ``obs``, everything computed on ``device``."""
    th = thetas.to(device)
    stats = tr.model.batch_ref_stats(th, tr.ref_batch.to(device))
    parts, _ = tr.model.prepare_batch_params((th, stats))
    return tr.model.batch_scores_parts(parts, obs.to(device), stats).cpu()


def check_generation(run: dict) -> None:
    """The generation's outputs are finite and of the expected shapes, and a
    small forward on the card agrees with the CPU's plain forward."""
    import torch

    tr = run["trainer"]
    D = tr.model.num_params
    pairs = SMOKE_OVERRIDES["population_size"] // 2
    cutoff = SMOKE_OVERRIDES["episode_cutoff_mode"]
    require(tr.iteration == 1, "the trainer did not finish its generation")
    require(tuple(tr.theta.shape) == (D,) and bool(torch.isfinite(tr.theta).all()), "θ is not finite [D]")
    lengths = tr.last_stats.lengths
    require(tr.last_stats.returns.shape == (pairs, 2), f"returns shape {tr.last_stats.returns.shape}")
    require(bool(((lengths >= 1) & (lengths <= cutoff)).all()), "episode lengths outside [1, cutoff]")
    require(math.isfinite(tr.last_stats.update_ratio), "update ratio is not finite")
    evals = tr.last_stats.eval_lengths
    require(evals.size == tr.config.num_eval_episodes == 8, f"EvalEpCount {evals.size}, expected 8")
    require(bool(((evals >= 1) & (evals <= cutoff)).all()) and bool(np.isfinite(tr.last_stats.eval_returns).all()),
            "eval episodes outside [1, cutoff] or with non-finite returns")

    # 4 perturbed members of the new θ on 4 reference frames, card vs CPU
    thetas, obs = perturbed_members(tr)
    card, cpu = (small_forward(tr, thetas, obs, dev) for dev in (tr.device, torch.device("cpu")))
    err = float((card - cpu).abs().max())
    tol = 1e-3 * max(1.0, float(cpu.abs().max()))  # float32, other summation orders
    print(f"forward card vs cpu: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"card forward disagrees with the CPU forward: {err} > {tol}")
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    require(bool((card.argmax(-1) == cpu.argmax(-1))[clear].all()), "argmax differs")


def perturbed_members(tr):
    """Four members θ + 0.02·ε of a trainer's θ and four reference frames,
    on the CPU."""
    import torch

    D = tr.model.num_params
    idx = torch.tensor([0, 1, 12345, tr.noise.size - D], dtype=torch.int32)
    thetas = tr.theta[None] + 0.02 * tr.noise.get_batch(idx.to(tr.noise.noise.device), D)
    return thetas.cpu(), tr.ref_batch[:4].cpu()


def kernel_counters():
    """Each kernel's wrapper, by kernel name; ``.launches`` is its count."""
    from deep_neuroevolution_torch.ops import fused_dqn as fk
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient
    from deep_neuroevolution_torch.ops.population_linear import population_linear

    return {f.__name__: f for f in (population_linear, noise_gradient, fk.large_dqn_fused_scores,
                                    fk.vbn_dqn_fused1_scores, fk.dqn_conv_chain_fused, fk.vbn_dqn_fused_scores)}


def zero_counters() -> None:
    for f in kernel_counters().values():
        f.launches = 0
    k1 = kernel_counters()["population_linear"]
    k1.bulk_launches = k1.general_launches = 0
    k1.launches_by_batch.clear()
    for name in ("large_dqn_fused_scores", "dqn_conv_chain_fused", "vbn_dqn_fused1_scores", "vbn_dqn_fused_scores"):
        kernel_counters()[name].launches_by_batch.clear()


def read_counters() -> dict:
    """Each kernel's launches, and K1's by variant."""
    counts = {name: f.launches for name, f in kernel_counters().items()}
    k1 = kernel_counters()["population_linear"]
    return {**counts, "population_linear.bulk": k1.bulk_launches, "population_linear.general": k1.general_launches}


def random_genomes(model, B: int, gen, device):
    """B first-generation GA genomes, θ = ε·scale_by, ε ~ N(0, 1)."""
    import torch

    sb = model.scale_by(model.scale_style, device)
    return torch.randn((B, model.num_params), generator=gen, device=device) * sb


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_top_actions(card, ref, tol: float, what: str) -> int:
    """Equal argmax wherever the reference's top two scores are more than
    ``tol`` apart; returns how many rows that is."""
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > tol
    require(bool((card.argmax(-1) == ref.argmax(-1))[clear].all()), f"{what}: argmax differs")
    return int(clear.sum())


def large_fused_bound(ops: dict, y):
    """K3's (bound_ms, bound_by) on ``ops``: every operand read once and
    the scores ``y`` written once, against its bf16 conv products and its
    float32 fc and out layer."""
    B = y.shape[0]
    conv_ops = 2 * B * (441 * 256 * 32 + 121 * 512 * 64 + 121 * 576 * 64)  # bf16 products
    f32_ops = 2 * B * (121 * 64 * 512 + 512 * 64)  # the fc (f32 x3) and the out layer
    return bound(nbytes(*ops.values(), y), {"bfloat16": conv_ops, "float32": f32_ops})


def check_large_fused(device) -> list:
    """K3 against its plain version on the same inputs. Tolerance
    1e-3·max|score|: both round conv1's and conv2's outputs to bf16 and sum
    in f32, in other orders, so a sum near a bf16 rounding boundary can
    round one ulp the other way (on an H100 up to 4.3e-4·max, at B=1 in
    tests/test_torch_cuda.py). Dropping those bf16 roundings moves the
    scores by 2e-3·max or more (tests/test_torch_dqn.py TestCardTolerance),
    so the limit holds the kernel to the JAX kernel's rounding points."""
    import torch

    from deep_neuroevolution_torch.models.core import extract_patches
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(3)
    rows = []
    for B in K3_BATCHES:
        for na in (4, 18):
            fused, split = (LargeDQN(num_actions=na, forward_impl=f) for f in ("fused", "split"))
            th = random_genomes(fused, B, gen, device)
            obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
            parts, _ = fused.prepare_batch_params((th, None))
            ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
            y = fk.large_dqn_fused_scores(ops)
            ref = fk.large_dqn_fused_scores_plain(ops)
            torch.cuda.synchronize()
            err = float((y[:, :na] - ref[:, :na]).abs().max())
            tol = 1e-3 * float(ref[:, :na].abs().max())
            require(bool(torch.isfinite(y).all()), "large_dqn_fused_scores returned non-finite values")
            require(err <= tol, f"large_dqn_fused_scores B={B} A={na}: max abs err {err} > {tol}")
            require(bool((y[:, na:] < -1e8).all()), "a padded action lane lost its -1e9 bias")
            clear = check_top_actions(y[:, :na], ref[:, :na], tol, f"large_dqn_fused_scores B={B} A={na}")
            require(torch.equal(y, fk.large_dqn_fused_scores(ops)), f"large_dqn_fused_scores B={B}: two launches differ")
            warm(lambda: fk.large_dqn_fused_scores(ops))
            ms = cuda_ms(lambda: fk.large_dqn_fused_scores(ops), 20)
            k3_graph_ms = graph_ms(lambda: fk.large_dqn_fused_scores(ops))
            plain_ms = cuda_ms(lambda: fk.large_dqn_fused_scores_plain(ops), 3, warmup=1)
            sparts, _ = split.prepare_batch_params((th, None))
            warm(lambda: split.batch_scores_parts(sparts, obs), 0.5)
            split_ms = cuda_ms(lambda: split.batch_scores_parts(sparts, obs), 10)
            bound_ms, bound_by = large_fused_bound(ops, y)
            row = dict(B=B, num_actions=na, max_abs_err=err, tol=tol, argmax_rows_checked=clear, ms=ms,
                       graph_ms=k3_graph_ms, plain_ms=plain_ms, split_ms=split_ms, library_ms=None, bound_ms=bound_ms,
                       bound_by=bound_by, bound_over_ms=bound_ms / ms, bound_over_graph_ms=bound_ms / k3_graph_ms)
            print("large_dqn_fused_scores " + json.dumps(row), flush=True)
            rows.append(row)
            del th, parts, ops, sparts, y, ref
            torch.cuda.empty_cache()
    return rows


def conv_chain_bound(cls, dt: str, B: int, args, y):
    """K5's bound at B members: the bytes of its inputs and output, and its
    products' operations at the rate of the compute dtype."""
    (_, c1, _, _), (_, c2, _, _) = cls.LAYERS[:2]
    c3 = cls.LAYERS[2][1] if len(cls.LAYERS) > 2 else 0
    ops = 2 * B * (441 * 256 * c1 + 121 * 16 * c1 * c2 + 121 * 9 * c2 * c3)
    return bound(nbytes(*(a for a in args if a is not None), y), ops, dt)


def conv_chain_case(cls, dt: str, B: int, gen, device):
    """K5's operands for B first-generation genomes of ``cls`` and random
    frames: the model, its fused parts, the frames and the kernel's args."""
    import torch

    from deep_neuroevolution_torch.models.dqn import LargeDQN

    kw = {"forward_impl": "split"} if cls is LargeDQN else {}
    model = cls(num_actions=4, compute_dtype=dt, conv_impl="fused", **kw)
    parts, _ = model.prepare_batch_params((random_genomes(model, B, gen, device), None))
    obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
    return model, parts, obs, model.conv_chain_args(parts, obs)


def check_conv_chain(device) -> list:
    """K5 against its plain version at each of ``K5_CASES``. float32:
    within 1e-5·max|x| (sums in another order). bfloat16: within
    1e-3·max|x|, as K3 (the bf16 roundings of the intermediates are kept;
    dropping them moves x by 2e-3·max or more, while the tensor cores'
    summation order stays inside). Timed back-to-back and in a CUDA graph;
    a second launch must repeat the first bit for bit."""
    import torch

    from deep_neuroevolution_torch import models
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(4)
    rows = []
    for name, dt, B in K5_CASES:
        cls = getattr(models, name)
        fused, parts, obs, args = conv_chain_case(cls, dt, B, gen, device)
        einsum = dataclasses.replace(fused, conv_impl="einsum")
        y = fk.dqn_conv_chain_fused(*args)
        ref = fk.dqn_conv_chain_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = (1e-5 if dt == "float32" else 1e-3) * float(ref.abs().max())
        require(bool(torch.isfinite(y).all()), "dqn_conv_chain_fused returned non-finite values")
        require(err <= tol, f"dqn_conv_chain_fused {name} {dt} B={B}: max abs err {err} > {tol}")
        require(torch.equal(y, fk.dqn_conv_chain_fused(*args)), f"dqn_conv_chain_fused {name} {dt} B={B}: two launches differ")
        warm(lambda: fk.dqn_conv_chain_fused(*args), 0.3)
        ms = cuda_ms(lambda: fk.dqn_conv_chain_fused(*args), 20)
        k5_graph_ms = graph_ms(lambda: fk.dqn_conv_chain_fused(*args))
        plain_ms = cuda_ms(lambda: fk.dqn_conv_chain_plain(*args), 5)
        einsum_ms = cuda_ms(lambda: einsum.conv_acts(parts, obs), 10)
        bound_ms, bound_by = conv_chain_bound(cls, dt, B, args, y)
        row = dict(model=name, dtype=dt, B=B, max_abs_err=err, tol=tol, ms=ms, graph_ms=k5_graph_ms,
                   plain_ms=plain_ms, einsum_ms=einsum_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   bound_over_graph_ms=bound_ms / k5_graph_ms)
        print("dqn_conv_chain_fused " + json.dumps(row), flush=True)
        rows.append(row)
        del parts, obs, args, y, ref
        torch.cuda.empty_cache()
    return rows


def run_ga(device) -> dict:
    """Two GA generations through the CLI; the tabular rows come back from
    the run's metrics.jsonl."""
    import torch

    from deep_neuroevolution_torch import main as cli

    with tempfile.TemporaryDirectory() as log_dir:
        argv = [
            "train", "--algo", "ga", "--exp_file", str(ROOT / "configurations" / "ga_atari_config.json"),
            "--iterations", "2", "--overrides", json.dumps(GA_OVERRIDES), "--device", str(device),
            "--log_dir", log_dir,
        ]
        print("main " + " ".join(argv), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        zero_counters()
        t0 = time.perf_counter()
        trainer = cli.cmd_train(cli.build_parser().parse_args(argv))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        by_batch = dict(sorted(kernel_counters()["large_dqn_fused_scores"].launches_by_batch.items()))
        peak = torch.cuda.max_memory_allocated(device)
        with open(Path(log_dir) / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
    print("launches " + json.dumps(launches), flush=True)
    require(launches["large_dqn_fused_scores"] > 0, "the GA never launched large_dqn_fused_scores")
    require(sum(by_batch.values()) == launches["large_dqn_fused_scores"], "K3's launches by batch size do not add up")
    return dict(trainer=trainer, seconds=seconds, launches=launches, k3_by_batch=by_batch, rows=rows, peak_bytes=peak)


def check_ga(run: dict) -> None:
    """The two generations' state, and a small forward of four parents on
    the card (K3) against the CPU's plain K3."""
    import torch

    from deep_neuroevolution_torch.models.dqn import LargeDQN

    tr = run["trainer"]
    st = tr.state
    pop = GA_OVERRIDES["population_size"]
    require(st.it == 2 and len(run["rows"]) == 2, "the GA did not finish two generations")
    require(len(st.population) == pop, f"population of {len(st.population)}")
    lens = [len(o.seeds) for o in st.population]
    # every chain of generation 2 has length 2; only the elite carried over
    # from generation 1 (num_elites) may keep its length-1 chain
    require(set(lens) <= {1, 2} and lens.count(1) <= tr.config.num_elites, f"chain lengths {sorted(set(lens))}")
    require(all(math.isfinite(o.fitness) for o in st.population), "non-finite fitness")
    th = tr.cached_parent_thetas
    n_parents = min(tr.config.selection_threshold, pop)
    require(th is not None and tuple(th.shape) == (n_parents, tr.model.num_params)
            and bool(torch.isfinite(th).all()), "parent cache is not finite [T, D]")
    for r in run["rows"]:
        require(r["PopulationEpCount"] >= pop and math.isfinite(r["PopulationEpRewMean"]), f"bad row {r}")

    gen = torch.Generator().manual_seed(5)
    obs = torch.rand((4, 84, 84, 4), generator=gen)
    na = tr.model.num_actions
    card_parts, _ = tr.model.prepare_batch_params((th[:4], None))
    require("__fused_lg__" in card_parts, "the card's LargeDQN forward is not on K3")
    card = tr.model.batch_scores_fused(card_parts["__fused_lg__"], obs.to(tr.device)).cpu()[:, :na]
    cpu_model = LargeDQN(num_actions=na, forward_impl="fused")
    cpu_parts, _ = cpu_model.prepare_batch_params((th[:4].cpu(), None))
    cpu = cpu_model.batch_scores_fused(cpu_parts["__fused_lg__"], obs)[:, :na]
    err = float((card - cpu).abs().max())
    tol = 1e-3 * float(cpu.abs().max())  # as in phase 5: the CPU sums in yet another order
    print(f"GA forward card (K3) vs cpu (plain): max abs err {err:.3g} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"card forward disagrees with the CPU's plain K3: {err} > {tol}")
    check_top_actions(card, cpu, tol, "GA forward")


def time_by_batch(name: str, by_batch: dict, make_call, rel_tol: float, lanes=None) -> dict:
    """A kernel at each batch size a path launched it with: ``make_call(B)``
    returns a call of the kernel on fresh operands of B members and a call
    of its plain version on the same operands. Each B is first checked
    against the plain version (the last axis's first ``lanes`` entries,
    within ``rel_tol``·max|ref|) and for a bit-for-bit second launch, then
    timed in a CUDA graph after a warm-up.
    Prints launches × time by batch size and the share of the kernel's time
    in batches below 128 (the ladder's buckets); returns those totals and
    the rows."""
    import torch

    rows = []
    for B, launches in by_batch.items():
        call, plain = make_call(B)
        y, ref = call(), plain()
        torch.cuda.synchronize()
        y, ref = y[..., :lanes], ref[..., :lanes]
        err, tol = float((y - ref).abs().max()), rel_tol * float(ref.abs().max())
        require(bool(torch.isfinite(y).all()), f"{name} B={B} returned non-finite values")
        require(err <= tol, f"{name} B={B}: max abs err {err} > {tol}")
        require(torch.equal(y, call()[..., :lanes]), f"{name} B={B}: two launches differ")
        del y, ref
        warm(call, 0.3)
        ms = graph_ms(call)
        rows.append(dict(B=B, launches=launches, graph_ms=ms, launches_x_ms=launches * ms, max_abs_err=err, tol=tol))
        print(f"{name}_by_batch " + json.dumps(rows[-1]), flush=True)
        del call, plain
        torch.cuda.empty_cache()
    total = sum(r["launches_x_ms"] for r in rows)
    small = sum(r["launches_x_ms"] for r in rows if r["B"] < 128)
    summary = dict(launches=sum(by_batch.values()), total_ms=total, below_128_ms=small,
                   below_128_share=small / total if total else 0.0)
    print(f"{name}_by_batch_total " + json.dumps(summary), flush=True)
    return dict(summary, rows=rows)


def time_large_fused_by_batch(device, by_batch: dict) -> dict:
    """K3 at each batch size a path (the GA, the chain replay, the toy GA
    campaign) launched it with, on first-generation genomes of a 4-action
    LargeDQN, checked and timed; each row also holds K3's bound at its B."""
    import torch

    from deep_neuroevolution_torch.models.core import extract_patches
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(7)
    model = LargeDQN(num_actions=4, forward_impl="fused")
    bounds = {}

    def make_call(B):
        parts, _ = model.prepare_batch_params((random_genomes(model, B, gen, device), None))
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
        ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
        bounds[B] = large_fused_bound(ops, torch.empty((B, fk.NOUT), dtype=torch.float32))
        return lambda: fk.large_dqn_fused_scores(ops), lambda: fk.large_dqn_fused_scores_plain(ops)

    # as phase 5: 1e-3·max|score| over the 4 actions (the other lanes carry the -1e9 bias)
    out = time_by_batch("large_dqn_fused_scores", by_batch, make_call, 1e-3, lanes=4)
    for r in out["rows"]:
        r["bound_ms"], r["bound_by"] = bounds[r["B"]]
    print("large_dqn_fused_scores_bound_by_batch " + json.dumps(
        {str(r["B"]): dict(bound_ms=r["bound_ms"], bound_by=r["bound_by"], graph_ms=r["graph_ms"]) for r in out["rows"]}),
        flush=True)
    return out


def time_conv_chain_by_batch(device, by_batch: dict) -> dict:
    """K5 at each batch size the RS generation launched it with, on
    first-generation SmallDQN genomes in float32 (the RS's route), checked
    and timed."""
    import torch

    from deep_neuroevolution_torch.models.dqn import SmallDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(8)

    def make_call(B):
        *_, args = conv_chain_case(SmallDQN, "float32", B, gen, device)
        return lambda: fk.dqn_conv_chain_fused(*args), lambda: fk.dqn_conv_chain_plain(*args)

    # as phase 6 in float32: 1e-5·max|x|
    return time_by_batch("dqn_conv_chain_fused", by_batch, make_call, 1e-5)


def run_rs(device) -> dict:
    """One random-search generation of rs_atari_config.json's SmallDQN with
    the K5 conv route, through the Python API."""
    import torch

    from deep_neuroevolution_torch import models
    from deep_neuroevolution_torch.algos.ga import GAConfig, RSTrainer
    from deep_neuroevolution_torch.envs.atari import AtariEnv
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    exp = json.loads((ROOT / "configurations" / "rs_atari_config.json").read_text())
    env = AtariEnv("toy", batch_size=RS_CUT["batch_size"])
    # the config names no conv route, as in the JAX package: K5 is asked for here
    model = dataclasses.replace(models.get_model(exp["model"])(num_actions=env.num_actions), conv_impl="fused")
    cfg = GAConfig(
        population_size=RS_CUT["population_size"],
        selection_threshold=exp["selection_threshold"],
        validation_threshold=exp["validation_threshold"],
        num_validation_episodes=exp["num_validation_episodes"],
        num_test_episodes=exp["num_test_episodes"],
        mutation_power=exp["mutation_power"],
        episode_cutoff_mode=RS_CUT["episode_cutoff_mode"],
        timesteps=exp["timesteps"],
    )
    print(f"RSTrainer {type(model).__name__} conv_impl=fused {json.dumps(dataclasses.asdict(cfg))}", flush=True)
    try:
        tr = RSTrainer(env, model, cfg, noise_table=NoiseTable.from_seed(count=RS_CUT["noise_size"], device=device),
                       device=device)
        torch.cuda.reset_peak_memory_stats(device)
        zero_counters()
        t0 = time.perf_counter()
        tr.train(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        k5_by_batch = dict(sorted(kernel_counters()["dqn_conv_chain_fused"].launches_by_batch.items()))
    finally:
        env.close()
    print("launches " + json.dumps(launches), flush=True)
    for name in ("dqn_conv_chain_fused", "population_linear"):
        require(launches[name] > 0, f"random search never launched {name}")
    require(sum(k5_by_batch.values()) == launches["dqn_conv_chain_fused"], "K5's launches by batch size do not add up")
    require(tr.state.it == 1 and tr.best_seeds is not None and len(tr.best_seeds) == 1
            and math.isfinite(tr.best_score), "random search kept no best genome")
    return dict(trainer=tr, seconds=seconds, launches=launches, k5_by_batch=k5_by_batch,
                peak_bytes=torch.cuda.max_memory_allocated(device))


def vbn_members(model, B: int, gen, device):
    """B members θ + 0.02·ε around a fresh init θ (the ES's perturbed
    population), ε ~ N(0, 1) drawn on the card."""
    import torch

    base = model.init_theta(torch.Generator().manual_seed(B), device)
    return base[None] + 0.02 * torch.randn((B, model.num_params), generator=gen, device=device)


def vbn_ops(impl: str, th, stats, obs, num_actions: int = 4) -> dict:
    """K4's (``impl='fused1'``) or K6's ('fused') operands: members θ with
    their reference stats, on the frames ``obs``."""
    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.models.core import extract_patches

    B = th.shape[0]
    parts, _ = VirtualBNDQN(num_actions=num_actions, forward_impl=impl).prepare_batch_params((th, stats))
    return dict(parts["__fused__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))


def vbn_random_ops(impl: str, B: int, gen, device, ref_frames) -> dict:
    """K4's or K6's operands for B perturbed members (vbn_members) with the
    stats of ``ref_frames``, on random frames."""
    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN

    model = VirtualBNDQN(num_actions=4)
    th = vbn_members(model, B, gen, device)
    obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
    return vbn_ops(impl, th, model.batch_ref_stats(th, ref_frames), obs)


def vbn_bound(impl: str, ops: dict, y):
    """K4's or K6's bound: the bytes of its operands and scores; the convs'
    bf16 products, the fc's at the type of x2 (float32 in K4, bf16 in K6)
    and the out layer's float32 ones."""
    B = ops["patches1"].shape[0]
    conv_ops = 2 * B * (441 * 256 * 16 + 121 * 256 * 32)
    fc_ops = 2 * B * 121 * 32 * 256
    f32_ops = 2 * B * 256 * 64
    return bound(nbytes(*ops.values(), y), {"bfloat16": conv_ops + (fc_ops if impl == "fused" else 0),
                                            "float32": f32_ops + (fc_ops if impl == "fused1" else 0)})


MIDPOINT = 1.0 + 2.0 ** -8  # halfway between the bf16 values 1 and 1 + 2^-7


def sequential(a, w):
    """a · w ([B, M, K] × [B, K, N]) as the near-tie recompute of K4, K5 and
    K6 sums: a float32 chain in k order from 0. a and w hold bf16 values, so
    each product is exact in float32 and each add rounds once, as an FMA
    does."""
    import torch

    out = torch.zeros(a.shape[0], a.shape[1], w.shape[2], device=a.device)
    for k in range(a.shape[2]):
        out = out + a[..., k:k + 1] * w[:, k:k + 1, :]
    return out


def vbn_all_ties_case(impl: str, B: int, device):
    """K4 (``impl='fused1'``) or K6 ('fused') operands on which every value
    of x1, and in K6 every value of x2 whose taps all lie inside x1, sits
    within a few float32 ulps of a bf16 rounding midpoint, so each conv
    notes thousands of near ties, more than the list holds (1024): every
    patch row of a member is its frame's centre patch, so a channel's sum
    repeats at all 441 positions (x2's at the 81 inner ones), and each
    shift c puts h·a + c on MIDPOINT. Returns the operands and the scores
    that the sequential chains give, which the kernel must match once it
    recomputes every value of the conv."""
    import torch

    from deep_neuroevolution_torch.models.core import extract_patches

    gen = torch.Generator(device=device).manual_seed(12)
    ops = vbn_random_ops(impl, B, gen, device, torch.rand((16, 84, 84, 4), generator=gen, device=device))
    row = ops["patches1"][:, 220:221]  # the centre patch, (10, 10)
    p1, w1, w2 = row.expand(-1, 441, -1).contiguous(), ops["w1"].float(), ops["w2"].float()
    a1, a2 = ops["a1"], ops["a2"]
    c1 = (MIDPOINT - (sequential(row.float(), w1) * a1).double()).float()
    x1 = torch.relu(sequential(p1.float(), w1) * a1 + c1).to(torch.bfloat16).float()
    x1p = extract_patches(x1.reshape(B, 21, 21, 16), 4, 2).reshape(B, 121, 256)
    ops = dict(ops, patches1=p1, c1=c1)
    if impl == "fused":
        ops["c2"] = (MIDPOINT - (sequential(x1p[:, 60:61], w2) * a2).double()).float()  # (5, 5): taps inside x1
        x2 = torch.relu(sequential(x1p, w2) * a2 + ops["c2"]).to(torch.bfloat16).float()
        h3 = torch.bmm(x2.reshape(B, 1, -1), ops["wf"].float())[:, 0]
    else:
        x2 = torch.relu(torch.bmm(x1p, w2) * a2 + ops["c2"])
        h3 = torch.einsum("bpc,bcpn->bn", x2, ops["wf_cm"].float())
    x3 = torch.relu(h3 * ops["a3"][:, 0] + ops["c3"][:, 0])
    return ops, torch.bmm(x3[:, None], ops["wo"])[:, 0] + ops["bo"][:, 0]


def check_vbn_fused(device) -> list:
    """K4 and K6 against their plain versions on the same inputs, with the
    stats of a reference batch of random frames. Tolerance 1e-3·max|score|:
    both keep the bf16 roundings (x1; x2 in K6) and sum in f32, in other
    orders (the convs on tensor cores), so a sum near a rounding boundary
    can round one ulp the other way; dropping or swapping a rounding point
    moves the scores by 3.7e-3·max or more (tests/test_torch_vbn_fused.py
    TestCardTolerance). A second launch must repeat the first bit for bit.
    Then the all-ties case, within 1e-5·max of the sequential chains, at
    B=3 (the split) and B=133 (the persistent grid, two members a block)."""
    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(6)
    ref_frames = torch.rand((128, 84, 84, 4), generator=gen, device=device)
    rows = []
    for B in VBN_BATCHES:
        for na in (4, 18):
            split = {dt: VirtualBNDQN(num_actions=na, compute_dtype=dt) for dt in ("float32", "bfloat16")}
            th = vbn_members(split["float32"], B, gen, device)
            stats = split["float32"].batch_ref_stats(th, ref_frames)
            obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
            split_ms = {}
            for dt, sm in split.items():
                sparts, _ = sm.prepare_batch_params((th, stats))
                split_ms[dt] = cuda_ms(lambda: sm.batch_scores_parts(sparts, obs, stats), 10)
                del sparts
            for impl, (name, plain_name) in VBN_ROUTES.items():
                fn, plain = getattr(fk, name), getattr(fk, plain_name)
                ops = vbn_ops(impl, th, stats, obs, na)
                y = fn(ops)
                ref = plain(ops)
                torch.cuda.synchronize()
                err = float((y[:, :na] - ref[:, :na]).abs().max())
                tol = 1e-3 * float(ref[:, :na].abs().max())
                require(bool(torch.isfinite(y).all()), f"{name} returned non-finite values")
                require(err <= tol, f"{name} B={B} A={na}: max abs err {err} > {tol}")
                require(bool((y[:, na:] < -1e8).all()), f"{name}: a padded action lane lost its -1e9 bias")
                clear = check_top_actions(y[:, :na], ref[:, :na], tol, f"{name} B={B} A={na}")
                require(torch.equal(y, fn(ops)), f"{name} B={B} A={na}: two launches differ")
                warm(lambda: fn(ops), 0.3)
                ms = cuda_ms(lambda: fn(ops), 20)
                k_graph_ms = graph_ms(lambda: fn(ops))
                plain_ms = cuda_ms(lambda: plain(ops), 3, warmup=1)
                bound_ms, bound_by = vbn_bound(impl, ops, y)
                row = dict(B=B, num_actions=na, max_abs_err=err, tol=tol, argmax_rows_checked=clear, ms=ms,
                           graph_ms=k_graph_ms, plain_ms=plain_ms, split_ms=split_ms["float32"],
                           split_bf16_ms=split_ms["bfloat16"], library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                           bound_over_graph_ms=bound_ms / k_graph_ms)
                print(f"{name} " + json.dumps(row), flush=True)
                rows.append(dict(row, name=name))
                del ops, y, ref
            del th, stats, obs
            torch.cuda.empty_cache()
    for impl, (name, _) in VBN_ROUTES.items():
        fn = getattr(fk, name)
        for B in (3, 133):
            ops, want = vbn_all_ties_case(impl, B, device)
            y = fn(ops)[:, :4]
            torch.cuda.synchronize()
            err, tol = float((y - want[:, :4]).abs().max()), 1e-5 * float(want[:, :4].abs().max())
            print(f"{name}_all_ties " + json.dumps(dict(B=B, max_abs_err=err, tol=tol)), flush=True)
            require(err <= tol, f"{name} all-ties case B={B}: max abs err {err} > {tol}")
            del ops, want, y
    return rows


def time_vbn_by_batch(device, impl: str, by_batch: dict) -> dict:
    """K4 or K6 at each batch size an ES generation launched it with, on
    perturbed members, checked against its plain version and timed."""
    import torch

    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(9)
    ref_frames = torch.rand((128, 84, 84, 4), generator=gen, device=device)
    name, plain_name = VBN_ROUTES[impl]
    fn, plain = getattr(fk, name), getattr(fk, plain_name)

    def make_call(B):
        ops = vbn_random_ops(impl, B, gen, device, ref_frames)
        return lambda: fn(ops), lambda: plain(ops)

    # as phase 9: 1e-3·max|score| over the 4 actions
    return time_by_batch(name, by_batch, make_call, 1e-3, lanes=4)


def run_es_route(device, impl: str) -> dict:
    """One ES generation of es_atari_config.json at phase 4's cut with the
    VBN-DQN on ``forward_impl=impl``, through the Python API."""
    import torch

    from deep_neuroevolution_torch import models
    from deep_neuroevolution_torch.algos.es import ESConfig, ESTrainer
    from deep_neuroevolution_torch.envs.atari import AtariEnv
    from deep_neuroevolution_torch.ops import optim
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    env = AtariEnv(SMOKE_OVERRIDES["game"], **SMOKE_OVERRIDES["env_kwargs"])
    # the config names no forward route, as in the JAX package: it is asked for here
    model = dataclasses.replace(models.get_model(exp["model"])(num_actions=env.num_actions), forward_impl=impl)
    cfg = ESConfig(
        l2coeff=exp["l2coeff"], noise_stdev=exp["mutation_power"], population_size=SMOKE_OVERRIDES["population_size"],
        return_proc_mode=exp["return_proc_mode"], episode_cutoff_mode=SMOKE_OVERRIDES["episode_cutoff_mode"],
    )
    print(f"ESTrainer {type(model).__name__} forward_impl={impl} {json.dumps(dataclasses.asdict(cfg))}", flush=True)
    try:
        tr = ESTrainer(env, model, cfg, optimizer=optim.make_optimizer(exp["optimizer"]["type"], **exp["optimizer"]["args"]),
                       noise_table=NoiseTable.from_seed(count=SMOKE_OVERRIDES["noise_size"], device=device),
                       device=device)
        zero_counters()
        t0 = time.perf_counter()
        tr.train(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
        by_batch = ({B: n for B, n in sorted(kernel_counters()[VBN_ROUTES[impl][0]].launches_by_batch.items())}
                    if impl in VBN_ROUTES else {})
        # one more pass of the eval episodes alone, for their share of the generation
        t0 = time.perf_counter()
        tr._host_eval(tr._draw_eval_seed())
        torch.cuda.synchronize()
        eval_seconds = time.perf_counter() - t0
    finally:
        env.close()
    print("launches " + json.dumps(launches), flush=True)
    name = VBN_ROUTES[impl][0] if impl in VBN_ROUTES else "population_linear"
    require(launches[name] > 0, f"forward_impl={impl!r} never launched {name}")
    if impl in VBN_ROUTES:
        print(f"{name}_launches_by_batch " + json.dumps(by_batch), flush=True)
        require(sum(by_batch.values()) == launches[name], f"{name}'s launches by batch size do not add up")
    return dict(trainer=tr, seconds=seconds, launches=launches, eval_seconds=eval_seconds, by_batch=by_batch)


def check_es_route(run: dict, impl: str) -> None:
    """The generation's outputs, and a small forward of four members of the
    new θ on the card (K4 or K6) against the CPU's plain version on the
    same θ and stats."""
    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN

    tr = run["trainer"]
    require(tr.iteration == 1 and bool(torch.isfinite(tr.theta).all()), "the trainer did not finish its generation")
    st = tr.last_stats
    require(st.returns.shape == (SMOKE_OVERRIDES["population_size"] // 2, 2) and bool(np.isfinite(st.returns).all()),
            f"returns {st.returns.shape}")
    require(st.eval_returns.size == 8 and bool(np.isfinite(st.eval_returns).all()),
            f"EvalEpCount {st.eval_returns.size}, expected 8")
    require(math.isfinite(st.update_ratio), "update ratio is not finite")

    if impl not in VBN_ROUTES:
        return  # the split route's card-vs-CPU check is phase 4's
    thetas, obs = perturbed_members(tr)
    stats = tr.model.batch_ref_stats(thetas.to(tr.device), tr.ref_batch.to(tr.device))
    card_parts, _ = tr.model.prepare_batch_params((thetas.to(tr.device), stats))
    require("__fused__" in card_parts, f"the card's forward is not on forward_impl={impl!r}")
    na = tr.model.num_actions
    card = tr.model.batch_scores_fused(card_parts["__fused__"], obs.to(tr.device)).cpu()[:, :na]
    cpu_model = VirtualBNDQN(num_actions=na, forward_impl=impl)
    cpu_stats = type(stats)(*(tuple(x.cpu() for x in f) for f in stats))  # the same stats on both sides
    cpu_parts, _ = cpu_model.prepare_batch_params((thetas, cpu_stats))
    cpu = cpu_model.batch_scores_fused(cpu_parts["__fused__"], obs)[:, :na]
    err = float((card - cpu).abs().max())
    tol = 1e-3 * float(cpu.abs().max())  # as in phase 9
    print(f"ES forward_impl={impl} card vs cpu (plain): max abs err {err:.3g} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"card forward disagrees with the CPU's plain version: {err} > {tol}")
    check_top_actions(card, cpu, tol, f"ES forward_impl={impl}")




# phases 13 and 14: the device envs' configurations, at their full size
DEVICE_CONFIGS = {"maze": "maze_es.json", "cartpole": "es_gym_config.json"}


@contextlib.contextmanager
def record_k2():
    """The (offsets, weights) that ES trainers hand K2, in a list, while
    the context is open."""
    from deep_neuroevolution_torch.algos import es

    real, seen = es.noise_gradient, []

    def recorded(table_, idxs, weights, dim, *rest):
        seen.append((idxs.clone(), weights.clone()))
        return real(table_, idxs, weights, dim, *rest)

    es.noise_gradient = recorded
    try:
        yield seen
    finally:
        es.noise_gradient = real


def check_k2(table, idx, w, dim: int) -> float:
    """K2 on one recorded call against its plain version, within phase 3's
    1e-5·max|g|; returns the max abs error."""
    import torch

    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain

    g, ref = noise_gradient(table, idx, w, dim), noise_gradient_plain(table, idx, w, dim)
    torch.cuda.synchronize()
    err, tol = float((g - ref).abs().max()), 1e-5 * float(ref.abs().max())
    require(bool(torch.isfinite(g).all()) and err <= tol, f"noise_gradient B={idx.shape[0]} D={dim}: {err} > {tol}")
    return err


def run_device_es(device, name: str, table) -> dict:
    """One ES generation of a device-env configuration at its full size,
    through the Python API (``config.load_experiment``, then ``train``), on
    the reference's 250M-float table that the process built once. Records
    K2's offsets and weights as the generation hands them over."""
    import torch

    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / DEVICE_CONFIGS[name]).read_text())
    tr = config.load_experiment(exp, device=device, noise_table=table)
    print(f"{name}: {type(tr.env).__name__} {type(tr.model).__name__} D={tr.model.num_params} "
          f"{json.dumps(dataclasses.asdict(tr.config))}", flush=True)
    with record_k2() as seen:
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_counters()
    print("launches " + json.dumps(launches), flush=True)
    require(launches["noise_gradient"] == len(seen) == 1, f"{name}: K2 launched {launches['noise_gradient']} times")
    return dict(trainer=tr, seconds=seconds, launches=launches, idx=seen[0][0], w=seen[0][1])


def check_device_es(run: dict, name: str) -> None:
    """The generation's outputs: finite, of the configuration's shapes, each
    episode within the cutoff; maze returns in [−diagonal, 0] (the reward
    is −distance to the goal at the last step), CartPole returns equal to
    the lengths (1 a step)."""
    import torch

    tr = run["trainer"]
    st, cutoff = tr.last_stats, tr.cutoff.tslimit
    require(tr.iteration == 1 and bool(torch.isfinite(tr.theta).all()), f"{name}: no finite θ after a generation")
    require(st.returns.shape == (tr.config.population_size // 2, 2), f"{name}: returns {st.returns.shape}")
    require(st.eval_returns.shape == (tr.config.num_eval_episodes,) == (8,), f"{name}: EvalEpCount {st.eval_returns.size}")
    for what, rets, lens in (("", st.returns, st.lengths), ("eval ", st.eval_returns, st.eval_lengths)):
        require(bool(np.isfinite(rets).all()) and bool(((lens >= 1) & (lens <= cutoff)).all()),
                f"{name}: {what}returns not finite or lengths outside [1, {cutoff}]")
        if name == "maze":
            segs = tr.env.cfg["segs"]
            diag = math.hypot(np.ptp(segs[:, [0, 2]]), np.ptp(segs[:, [1, 3]]))
            require(bool(((rets >= -diag) & (rets <= 0)).all()) and bool((lens == 400).all()),
                    f"{name}: {what}returns outside [-{diag:.1f}, 0] or episodes not 400 steps")
        else:
            require(bool((rets == lens).all()), f"{name}: {what}returns differ from the lengths")
    require(math.isfinite(st.update_ratio), f"{name}: update ratio is not finite")


def graph_against_eager(tr, idx) -> dict:
    """The generation's rollout (its population, its own noise offsets
    around the new θ, one reset seed) on the card twice: through the
    rollout's CUDA graphs, as the trainer runs it, and eagerly (a check
    interval past the cutoff, so that nothing is captured). Every result
    must be equal bit for bit; returns both wall times."""
    import torch

    from deep_neuroevolution_torch.algos import rollout

    def run():
        state, gen = tr._episode_starts(7, idx.shape[0], paired=True)
        params = tr._device_params(tr._perturbed(idx), tr._model_ctx(True, gen, paired=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rollout.rollout_batch(tr.env, tr.model.make_batch_act(), params, state, int(tr.cutoff.tslimit), True)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (graphed, graph_s), saved = run(), rollout.CHECK_EVERY
    rollout.CHECK_EVERY = 10**9
    try:
        eager, eager_s = run()
    finally:
        rollout.CHECK_EVERY = saved
    for name, a, b in zip(rollout.RolloutResult._fields, graphed, eager):
        require(torch.equal(a, b), f"the graphed rollout's {name} differs from the eager one")
    out = dict(members=2 * idx.shape[0], steps=int(eager.lengths.max()), timesteps=int(eager.lengths.sum()),
               graph_seconds=graph_s, eager_seconds=eager_s)
    print("rollout_graph_vs_eager " + json.dumps(out), flush=True)
    return out


def maze_members(tr, members: int = 8):
    """``members`` perturbed members of a maze trainer's θ, on the card."""
    import torch

    D = tr.model.num_params
    idx = torch.from_numpy(np.linspace(0, tr.noise.size - D, members).astype(np.int32)).to(tr.device)
    return tr.theta[None] + tr.config.noise_stdev * tr.noise.get_batch(idx, D)


def maze_teacher_forced(env, model, thetas, what: str = "maze") -> dict:
    """A whole 400-step maze episode of the members ``thetas`` recorded on
    the card; then each recorded state goes through the CPU's observe,
    forward and step (fed the card's actions), and that one step must
    match the card's: observations and actions within 1e-5, the state and
    reward within 1e-4 (a few float32 ulps of a coordinate near 200: sin,
    cos and division round otherwise on the card), done and the step
    counter exactly. Returns the errors and the card's positions after each
    step, ``[400, members, 2]``."""
    import torch

    members = thetas.shape[0]
    parts = {k: v.contiguous() for k, v in model.unflatten(thetas).items()}
    state, rec = env.reset(members, None, thetas.device), []
    for _ in range(400):
        obs = env.observe(state)
        a = model.batch_act_parts(parts, obs)
        nstate, r, d = env.step(state, a)
        rec.append(tuple(x.cpu() for x in (*state, obs, a, *nstate, r, d)))
        state = nstate
    cpu_parts = model.unflatten(thetas.cpu())
    n = len(state)
    errs = dict(obs=0.0, action=0.0, state=0.0, reward=0.0)
    moved = undone = 0
    for step in rec:
        s, obs, a, ns, r, d = (type(state)(*step[:n]), step[n], step[n + 1], type(state)(*step[n + 2:2 * n + 2]),
                               step[-2], step[-1])
        obs_c = env.observe(s)
        a_c = model.batch_act_parts(cpu_parts, obs_c)
        ns_c, r_c, d_c = env.step(s, a)
        errs["obs"] = max(errs["obs"], float((obs_c - obs).abs().max()))
        errs["action"] = max(errs["action"], float((a_c - a).abs().max()))
        errs["state"] = max(errs["state"], max(float((x - y).abs().max()) for x, y in zip(ns_c[:5], ns[:5])))
        errs["reward"] = max(errs["reward"], float((r_c - r).abs().max()))
        require(torch.equal(d_c, d) and torch.equal(ns_c.t, ns.t), f"{what}: done or the step counter differs")
        moved += int(((ns.x != s.x) | (ns.y != s.y)).sum())
        undone += int(((ns.x == s.x) & (ns.y == s.y) & (ns.speed != 0)).sum())  # a wall in the way
    print(f"{what}_teacher_forced " + json.dumps(dict(members=members, steps=len(rec), moves=moved,
                                                      moves_undone=undone, **errs)), flush=True)
    for k, tol in (("obs", 1e-5), ("action", 1e-5), ("state", 1e-4), ("reward", 1e-4)):
        require(errs[k] <= tol, f"{what}: card vs CPU {k} max abs err {errs[k]} > {tol}")
    require(moved > 0, f"{what}: no member moved")
    positions = torch.stack([torch.stack(step[n + 2 : n + 4], dim=1) for step in rec])  # nstate's x, y
    return dict(errs, positions=positions)

def k2_path_row(launches: dict, row: dict) -> dict:
    """K2's launches on a path and its numbers at that path's shape."""
    return dict(launches=launches["noise_gradient"],
                **{k: row[k] for k in ("B", "D", "table", "ms", "graph_ms", "bound_ms", "bound_by", "l2_floor_ms",
                                       "plain_ms", "library_ms", "max_abs_err")})


# phases 16 and 17: NS-ES on the maze, whole, and on the host engine (the
# game cut to ToyCatch), on phase 13's table
NS_MAZE, NS_MAZE_ITERATIONS = "maze_nses.json", 3
NS_HOST, NS_HOST_ITERATIONS = ("frostbite_nses.json", "frostbite_nsres.json"), 2


def run_maze_ns(device, table) -> dict:
    """NS_MAZE_ITERATIONS iterations of maze_nses.json through the Python
    API; each iteration's card novelty against the CPU's plain computation
    of the same BCs and archive snapshot (rtol 1e-6)."""
    import torch

    from deep_neuroevolution_torch.ops import novelty
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / NS_MAZE).read_text())
    zero_counters()
    tr = config.load_experiment(exp, device=device, noise_table=table)
    print(f"maze_ns: {type(tr.env).__name__} {type(tr.model).__name__} D={tr.model.num_params} "
          f"{json.dumps(dataclasses.asdict(tr.config))}", flush=True)
    rows = []
    with record_k2() as seen:
        for _ in range(NS_MAZE_ITERATIONS):
            snap = tr.archive  # archive_add leaves it as it was
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = tr.train_step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            n = st.novelty.shape[0]
            cpu = novelty.novelty_vs_archive(novelty.Archive(snap.points.cpu(), snap.count.cpu()),
                                             torch.from_numpy(st.bc.reshape(2 * n, -1)), tr.config.k).numpy()
            cpu = cpu.reshape(n, 2)
            rel = float(np.max(np.abs(st.novelty - cpu) / np.maximum(np.abs(cpu), 1e-30)))
            require(np.allclose(st.novelty, cpu, rtol=1e-6, atol=0),
                    f"maze NS: card novelty differs from the CPU's (max rel err {rel})")
            steps = int(st.lengths.sum())
            rows.append(dict(iteration=tr.iteration, parent=st.parent, seconds=seconds, timesteps=steps,
                             steps_per_s=steps / seconds, return_mean=float(st.returns.mean()),
                             novelty_mean=float(st.novelty.mean()), novelty_max_rel_err=rel,
                             archive=tr._archive_size(), selection_probs=st.selection_probs.tolist()))
            print("maze_ns_iteration " + json.dumps(rows[-1]), flush=True)
            require(st.returns.shape == (128, 2) and bool((st.lengths == 400).all()),
                    f"maze NS: returns {st.returns.shape}, lengths not 400")
        launches = read_counters()
    print("launches " + json.dumps({**launches, "population_linear.by_batch": by_batch_k1()}), flush=True)
    require(launches["noise_gradient"] == len(seen) == NS_MAZE_ITERATIONS,
            f"maze NS: K2 launched {launches['noise_gradient']} times in {NS_MAZE_ITERATIONS} iterations")
    require(tr._archive_size() == 3 + NS_MAZE_ITERATIONS, f"maze NS: archive size {tr._archive_size()}")
    require(all(bool(torch.isfinite(p.theta).all()) for p in tr.parents), "maze NS: a parent's θ is not finite")
    errs = [check_k2(table.noise, idx, w, tr.model.num_params) for idx, w in seen]
    return dict(trainer=tr, rows=rows, launches=launches, seen=seen, k2_errs=errs)


def plain_traj_novelty(archive, bc, k: int) -> float:
    """The length-tolerant k-NN novelty (nses.py:12-32) written out in
    float64: the shared prefix's squared distance plus the longer tail's
    against the shorter trajectory's last element."""
    bc = np.asarray(bc, np.float64)
    ds = []
    for p in archive:
        p = np.asarray(p, np.float64)
        short, long_ = (p, bc) if len(p) <= len(bc) else (bc, p)
        n = len(short)
        ds.append(math.sqrt(float(np.sum((long_[:n] - short) ** 2)) + float(np.sum((long_[n:] - short[-1]) ** 2))))
    return float(np.mean(np.sort(ds)[:k]))


def by_batch_k1() -> dict:
    from deep_neuroevolution_torch.ops.population_linear import population_linear

    return {f"B={b} {v}": n for (b, v), n in sorted(population_linear.launches_by_batch.items())}


def run_host_ns(device, name: str, table) -> dict:
    """NS_HOST_ITERATIONS iterations of a frostbite NS configuration through
    the loader; counters zeroed before the loader (the parents' mean-BC
    episodes are part of the path)."""
    import torch

    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / name).read_text())
    zero_counters()
    t0 = time.perf_counter()
    tr = config.load_experiment(exp, device=device, noise_table=table)
    setup = time.perf_counter() - t0
    print(f"{name}: {type(tr.env).__name__}(episodic_life={tr.env.episodic_life}, slots={tr.env.batch_size}) "
          f"{type(tr.model).__name__} D={tr.model.num_params} {json.dumps(dataclasses.asdict(tr.config))}", flush=True)
    novelty_seconds = []
    real = tr._archive_novelty

    def timed(bcs):
        t = time.perf_counter()
        out = real(bcs)
        novelty_seconds.append(time.perf_counter() - t)
        return out

    tr._archive_novelty = timed
    rows = []
    try:
        with record_k2() as seen:
            for _ in range(NS_HOST_ITERATIONS):
                snap = list(tr.host_archive)
                novelty_seconds.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = tr.train_step()
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                ref = np.array([plain_traj_novelty(snap, b, tr.config.k) for b in st.bc], np.float32)
                require(np.allclose(st.novelty.T.reshape(-1), ref, rtol=1e-6, atol=0),
                        f"{name}: novelty differs from the float64 recomputation")
                steps = int(st.lengths.sum())
                rows.append(dict(iteration=tr.iteration, parent=st.parent, seconds=seconds, timesteps=steps,
                                 frames_per_s=4 * steps / seconds, episodes=int(st.lengths.size),
                                 length_mean=float(st.lengths.mean()), length_max=int(st.lengths.max()),
                                 return_mean=float(st.returns.mean()), novelty_mean=float(st.novelty.mean()),
                                 novelty_seconds=novelty_seconds[:1], selection_novelty_seconds=novelty_seconds[1:],
                                 traj_floats=int(sum(b.size for b in st.bc)), archive=tr._archive_size()))
                print(f"{name.split('.')[0]}_iteration " + json.dumps(rows[-1]), flush=True)
            launches = read_counters()
    finally:
        del tr._archive_novelty
    by_batch = by_batch_k1()
    print("launches " + json.dumps({**launches, "population_linear.by_batch": by_batch}), flush=True)
    require(by_batch.get("B=128 bulk", 0) > 0 and any(k.startswith("B=1 ") for k in by_batch),
            f"{name}: K1 did not launch at B=128 (bulk) and B=1: {by_batch}")
    npairs = tr._npairs_round()
    require(launches["noise_gradient"] == len(seen) == NS_HOST_ITERATIONS
            and all(idx.shape[0] == npairs for idx, _ in seen), f"{name}: K2 launches {launches['noise_gradient']}")
    require(tr._archive_size() == 3 + NS_HOST_ITERATIONS, f"{name}: archive size {tr._archive_size()}")
    require(all(bool(torch.isfinite(p.theta).all()) for p in tr.parents), f"{name}: a parent's θ is not finite")
    errs = [check_k2(table.noise, idx, w, tr.model.num_params) for idx, w in seen]
    # 4 perturbed members of the current θ on 4 reference frames, card vs CPU (as phase 4)
    thetas, obs = perturbed_members(tr)
    card, cpu = (small_forward(tr, thetas, obs, dev) for dev in (tr.device, torch.device("cpu")))
    err = float((card - cpu).abs().max())
    tol = 1e-3 * max(1.0, float(cpu.abs().max()))
    print(f"{name} forward card vs cpu: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"{name}: card forward disagrees with the CPU forward: {err} > {tol}")
    return dict(trainer=tr, rows=rows, launches=launches, by_batch=by_batch, seen=seen, k2_errs=errs, setup=setup)


# phase 18: frostbite_es.json whole (quota mode) on phase 13's table
QUOTA_CONFIG = "frostbite_es.json"


def quota_rounds(lengths, npairs: int, episodes: int, timesteps: int) -> int:
    """The JAX package's host rule (its es.py:772-801): rounds of ``npairs``
    pairs until both quotas are met, counted from the rounds' lengths."""
    per_round = lengths.reshape(-1, npairs * 2).sum(axis=1)
    for r in range(1, per_round.size + 1):
        if 2 * npairs * r >= episodes and per_round[:r].sum() >= timesteps:
            return r
    return -1


def run_quota_es(device, table) -> dict:
    """One generation of frostbite_es.json through the loader, nothing cut
    but the game: rounds of 64 pairs on 256 slots until 5000 episodes and
    10,000 steps are met, then 50 eval episodes (eval_prob 0.01 × 5000)."""
    import torch

    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / QUOTA_CONFIG).read_text())
    zero_counters()
    t0 = time.perf_counter()
    tr = config.load_experiment(exp, device=device, noise_table=table)
    setup = time.perf_counter() - t0
    cfg = tr.config
    print(f"frostbite_es: {type(tr.env).__name__}(episodic_life={tr.env.episodic_life}, slots={tr.env.batch_size}) "
          f"{type(tr.model).__name__} D={tr.model.num_params} {json.dumps(dataclasses.asdict(cfg))}", flush=True)
    try:
        with record_k2() as seen:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = tr.train_step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counters()
    finally:
        tr.close()
    by_batch = by_batch_k1()
    print("launches " + json.dumps({**launches, "population_linear.by_batch": by_batch}), flush=True)
    npairs = tr._npairs_round()
    episodes, steps = int(st.lengths.size), int(st.lengths.sum())
    rounds = st.lengths.shape[0] // npairs
    rule = quota_rounds(st.lengths, npairs, cfg.episodes_per_batch, cfg.timesteps_per_batch)
    out = dict(config=QUOTA_CONFIG, cut="Frostbite → ToyCatch", setup_seconds=setup, seconds=seconds,
               episodes=episodes, timesteps=steps, frames_per_s=4 * steps / seconds, pairs_a_round=npairs,
               rounds=rounds, jax_rule_rounds=rule, padded_slots_a_round=tr.env.batch_size - 2 * npairs,
               length_mean=float(st.lengths.mean()), length_max=int(st.lengths.max()),
               eval_episodes=int(st.eval_returns.size), return_mean=float(st.returns.mean()),
               eval_return_mean=float(st.eval_returns.mean()))
    print("frostbite_es_generation " + json.dumps(out), flush=True)
    require(tr.quota_mode and episodes >= cfg.episodes_per_batch and steps >= cfg.timesteps_per_batch,
            f"frostbite_es: quotas not met ({episodes} episodes, {steps} steps)")
    require(rounds == rule and st.lengths.shape[0] % npairs == 0, f"frostbite_es: {rounds} rounds, the JAX rule {rule}")
    require(st.eval_returns.size == cfg.num_eval_episodes == 50, f"frostbite_es: {st.eval_returns.size} eval episodes")
    require(bool(np.isfinite(st.returns).all()) and bool(torch.isfinite(tr.theta).all()), "frostbite_es: not finite")
    require(launches["population_linear"] > 0 and launches["noise_gradient"] == len(seen) == 1,
            f"frostbite_es: K1 {launches['population_linear']}, K2 {launches['noise_gradient']} launches")
    idx, w = seen[0]
    require(idx.shape[0] == episodes // 2, f"frostbite_es: K2 summed {idx.shape[0]} pairs of {episodes} episodes")
    err = check_k2(table.noise, idx, w, tr.model.num_params)
    thetas, obs = perturbed_members(tr)
    card, cpu = (small_forward(tr, thetas, obs, dev) for dev in (tr.device, torch.device("cpu")))
    ferr, tol = float((card - cpu).abs().max()), 1e-3 * max(1.0, float(cpu.abs().max()))
    print(f"frostbite_es forward card vs cpu: max abs err {ferr:.3g} (tol {tol:.3g})", flush=True)
    require(ferr <= tol, f"frostbite_es: card forward disagrees with the CPU forward: {ferr} > {tol}")
    return dict(trainer=tr, stats=out, launches=launches, by_batch=by_batch, idx=idx, w=w, k2_err=err)


# phase 19: long runs on the card
def train_cli(log_dir: str, exp_file: str, iterations: int, overrides: dict, device) -> object:
    """``main train`` with a log directory and a snapshot every generation;
    returns the trainer."""
    from deep_neuroevolution_torch import main as cli

    argv = ["train", "--exp_file", str(ROOT / "configurations" / exp_file), "--log_dir", log_dir,
            "--iterations", str(iterations), "--snapshot_freq", "1", "--overrides", json.dumps(overrides),
            "--device", str(device)]
    return cli.cmd_train(cli.build_parser().parse_args(argv))


def check_resume(exp_file: str, overrides: dict, device) -> dict:
    """3 generations straight through against 2, then a resumed run of 1:
    θ (every parent's for NS-ES) and the last generation's returns and
    lengths bit for bit; the straight run's policy file of generation 3
    loads back to its θ."""
    import torch

    from deep_neuroevolution_torch.utils import checkpoint

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        a = train_cli(f"{d}/a", exp_file, 3, overrides, device)
        straight = time.perf_counter() - t0
        train_cli(f"{d}/b", exp_file, 2, overrides, device)
        b = train_cli(f"{d}/b", exp_file, 1, overrides, device)
        require(a.iteration == b.iteration == 3, f"{exp_file}: iterations {a.iteration}, {b.iteration}")
        thetas = [(p.theta, q.theta) for p, q in zip(a.parents, b.parents)] if hasattr(a, "parents") else []
        require(all(torch.equal(x, y) for x, y in [(a.theta, b.theta), *thetas]),
                f"{exp_file}: the resumed run's θ differs from the straight run's")
        for f in ("returns", "lengths"):
            require(np.array_equal(getattr(a.last_stats, f), getattr(b.last_stats, f)),
                    f"{exp_file}: the resumed run's {f} differ")
        (policy,) = Path(f"{d}/a").glob("snapshot_iter00003_rew*.pkl")
        _, theta, _ = checkpoint.load_policy_snapshot(str(policy), device=a.device)
        theta_a = a.parents[a.curr_parent].theta if hasattr(a, "parents") else a.theta
        require(torch.equal(theta, theta_a), f"{exp_file}: the policy file does not load back to θ")
    out = dict(config=exp_file, overrides=overrides, straight_seconds=straight, theta_equal=True,
               policy_file=policy.name)
    print("resume " + json.dumps(out), flush=True)
    return out


def check_mirrored_pairs(device) -> dict:
    """Phase 4's cut with ``mirror_crn`` and σ = 0 (a pair's θ halves
    equal): each pair's returns and lengths are equal."""
    from deep_neuroevolution_torch.ops.noise import NoiseTable
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    ov = {**SMOKE_OVERRIDES, "mirror_crn": True, "num_eval_episodes": 0}
    table = NoiseTable.from_seed(count=ov.pop("noise_size"), device=device)
    tr = config.load_experiment({**exp, "mutation_power": 0.0}, overrides=ov, device=device, noise_table=table)
    try:
        st = tr.train_step()
    finally:
        tr.close()
    equal = np.array_equal(st.returns[:, 0], st.returns[:, 1]) and np.array_equal(st.lengths[:, 0], st.lengths[:, 1])
    out = dict(pairs=int(st.returns.shape[0]), pairs_a_round=tr._npairs_round(), equal=bool(equal),
               distinct_lengths=int(np.unique(st.lengths).size))
    print("mirrored_pairs " + json.dumps(out), flush=True)
    require(tr.config.mirror_crn and equal, "mirror_crn: a pair's members with equal θ ran different episodes")
    return out


def check_maze_quota(device, table) -> dict:
    """One quota-mode generation of maze_es.json (1024 episodes and 300,000
    steps): both quotas met."""
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    ov = {"episodes_per_batch": 1024, "timesteps_per_batch": 300_000}
    tr = config.load_experiment(exp, overrides=ov, device=device, noise_table=table)
    t0 = time.perf_counter()
    st = tr.train_step()
    seconds = time.perf_counter() - t0
    out = dict(overrides=ov, seconds=seconds, episodes=int(st.lengths.size), timesteps=int(st.lengths.sum()),
               rounds_per_estimate=tr.last_dispatches)
    print("maze_quota " + json.dumps(out), flush=True)
    require(tr.quota_mode and out["episodes"] >= tr.config.episodes_per_batch
            and out["timesteps"] >= tr.config.timesteps_per_batch, f"maze quota: not met, {out}")
    return out


# phase 20: frostbite_ga.json whole as a GA (CPU-style chains), on phase 13's table
GA_CPU_CONFIG, GA_CPU_GENERATIONS = "frostbite_ga.json", 3


def plain_forward(model, thetas, obs, device):
    """Scores of ``thetas`` on ``obs`` through the split route, computed on
    ``device`` (K1 for the fc on a card, its plain version on the CPU)."""
    parts, ctx = model.prepare_batch_params((thetas.to(device), None))
    return model.batch_scores_parts(parts, obs.to(device), ctx).cpu()


def run_frostbite_ga(device, table) -> dict:
    """Three generations of frostbite_ga.json through the loader with
    ``algo='ga'``, nothing cut but the game (Frostbite → ToyCatch with
    EpisodicLife, 256 slots, SmallDQN at full width, population 10 padded
    to a 16-slot bucket, σ = 0.005): bare-index chains of length 3 by the
    third generation; every cached parent's θ rebuilt whole by
    ``theta_from_seed_chain(..., 'cpu')`` against the trainer's cache
    (one rounding a step against two: within 1e-6, the JAX package's own
    bound in its tests/test_ga.py); the elite's forward on four engine
    stacks, card (K1) against the CPU."""
    import torch

    from deep_neuroevolution_torch.algos.rollout_host import collect_ref_batch_host
    from deep_neuroevolution_torch.utils import checkpoint, config

    exp = json.loads((ROOT / "configurations" / GA_CPU_CONFIG).read_text())
    tr = config.load_experiment(exp, device=device, algo="ga", noise_table=table)
    cfg = tr.config
    print(f"frostbite_ga: {type(tr).__name__} {type(tr.model).__name__} D={tr.model.num_params} "
          f"slots={tr.env.batch_size} {json.dumps(dataclasses.asdict(cfg))}", flush=True)
    seconds, steps = [], []
    try:
        zero_counters()
        for _ in range(GA_CPU_GENERATIONS):
            before = tr.state.timesteps_so_far
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            steps.append(tr.state.timesteps_so_far - before)
        launches = read_counters()
        by_batch = by_batch_k1()
        obs = collect_ref_batch_host(tr.env, 7, device, batch_size=4)  # four stacks of engine frames
    finally:
        tr.close()
    print("launches " + json.dumps({**launches, "population_linear.by_batch": by_batch}), flush=True)
    st = tr.state
    require(launches["population_linear"] > 0, "frostbite_ga: K1 never launched")
    require(st.it == GA_CPU_GENERATIONS and len(st.population) == cfg.population_size, "frostbite_ga: no 3 generations")
    require(cfg.genome_style == "cpu" and all(isinstance(i, int) for o in st.population for i in o.seeds),
            "frostbite_ga: chains are not CPU-style bare indices")
    lens = [len(o.seeds) for o in st.population]
    require(max(lens) == GA_CPU_GENERATIONS, f"frostbite_ga: chain lengths {sorted(set(lens))}")
    require(all(math.isfinite(o.fitness) for o in st.population), "frostbite_ga: non-finite fitness")
    gaps = []
    for seeds, cached in zip(tr.cached_parent_seeds, tr.cached_parent_thetas):
        whole = checkpoint.theta_from_seed_chain(tr.model, tr.noise, list(seeds), "cpu", cfg.noise_stdev)
        gaps.append(float((whole - cached).abs().max()))
    elite = tr._lookup_theta(st.elite.seeds)[None]
    card, cpu = (plain_forward(tr.model, elite.expand(4, -1), obs, dev) for dev in (device, torch.device("cpu")))
    err, tol = float((card - cpu).abs().max()), 1e-3 * max(1.0, float(cpu.abs().max()))
    out = dict(config=GA_CPU_CONFIG, cut="Frostbite → ToyCatch", seconds=seconds, timesteps=steps,
               frames_per_s=[4 * n / t for n, t in zip(steps, seconds)], chain_lengths=sorted(set(lens)),
               parents=len(gaps), max_parent_chain=max(len(s) for s in tr.cached_parent_seeds),
               cache_vs_whole_chain_max_abs=max(gaps), elite_forward_err=err, elite_forward_tol=tol,
               elite=list(st.elite.seeds), k1_by_batch=by_batch)
    print("frostbite_ga_run " + json.dumps(out), flush=True)
    require(max(gaps) <= 1e-6, f"frostbite_ga: a cached parent differs from its whole chain by {max(gaps)}")
    require(err <= tol, f"frostbite_ga: card forward of the elite disagrees with the CPU's: {err} > {tol}")
    return dict(launches=launches, by_batch=by_batch, stats=out)


# phase 21: the GA/RS device arm, on phase 13's table
class DrawRecorder:
    """A GA trainer's offspring draws, its reset states (copied to the
    CPU) and its fitness passes' results, as the trainer makes them."""

    def __init__(self, tr):
        self.offspring, self.starts, self.passes = [], [], []
        draw, starts, fitness = tr._draw_offspring, tr._episode_starts, tr._fitness_pass

        def draw_rec(n, n_parents):
            self.offspring.append(draw(n, n_parents))
            return self.offspring[-1]

        def starts_rec(seed, n):
            state = starts(seed, n)
            self.starts.append(type(state)(*(x.cpu() for x in state)))
            return state

        def fitness_rec(n, power, randomize):
            out = fitness(n, power, randomize)
            self.passes.append(dict(rounds=len(self.offspring), n=n, power=power, randomize=randomize, out=out))
            return out

        tr._draw_offspring, tr._episode_starts, tr._fitness_pass = draw_rec, starts_rec, fitness_rec


def replay_first_pass_on_cpu(tr, rec: DrawRecorder, cpu_table, tol: float) -> dict:
    """The card trainer's first fitness pass again on the CPU, free-running
    from the card's draws and reset states: how many members' returns
    agree within ``tol``. A reading, not a check: the float32 physics and
    forwards round otherwise on the card, and an argmax near a tie or a
    wall lets a long episode part (``teacher_forced_first_round`` checks
    the steps)."""
    from deep_neuroevolution_torch.algos.ga import GATrainer

    first = rec.passes[0]
    offspring, starts = list(rec.offspring[:first["rounds"]]), list(rec.starts[:first["rounds"]])
    ctr = GATrainer(tr.env, tr.model, tr.config, noise_table=cpu_table, device="cpu")
    ctr._draw_offspring = lambda n, n_parents: offspring.pop(0)
    ctr._draw_seed = lambda: 0
    ctr._episode_starts = lambda seed, n: starts.pop(0)
    out = ctr._fitness_pass(first["n"], first["power"], first["randomize"])
    require(not offspring and not starts, "replay: the CPU drew fewer rounds than the card")
    require(np.array_equal(first["out"][1], out[1]), "replay: the CPU's noise offsets differ from the card's")
    card, cpu, lc, lp = first["out"][2], out[2], first["out"][3], out[3]
    part = np.abs(card - cpu) > tol
    return dict(members=int(card.size), agree=int((~part).sum()), max_abs_diff=float(np.abs(card - cpu).max()),
                tol=tol, shortest_parted_episode=int(np.minimum(lc, lp)[part].min()) if part.any() else None,
                return_mean_card=float(card.mean()), return_mean_cpu=float(cpu.mean()))


def teacher_forced_first_round(tr, rec: DrawRecorder, max_steps: int) -> dict:
    """The first fitness round's members (their θ from the recorded draws,
    their recorded reset states) stepped on the card for up to
    ``max_steps`` steps, recording every state; then each recorded state
    through the CPU's observe, forward and step, fed the card's actions.
    Observations and float state fields within 1e-5, rewards within 1e-4
    (maze coordinates up to ~200, where sin, cos and division round
    otherwise on the card), the rest of the state exactly; discrete actions
    equal except where the CPU's top two scores lie within 1e-5 (a near
    tie), continuous ones within 1e-5."""
    import torch

    env, model, first = tr.env, tr.model, rec.passes[0]
    pidx, midx = rec.offspring[0]
    thetas = tr._offspring_thetas(pidx, midx, first["power"], first["randomize"])
    parts = model.prepare_batch_params((thetas, None))[0]
    state = type(rec.starts[0])(*(x.to(tr.device) for x in rec.starts[0]))
    recs = []
    for _ in range(max_steps):
        obs = env.observe(state)
        a = model.batch_act_parts(parts, obs)
        nstate, r, d = env.step(state, a)
        recs.append(tuple(x.cpu() for x in (*state, obs, a, *nstate, r)))
        state = nstate
        if bool(getattr(state, "done", d).all()):
            break
    cpu_parts = model.prepare_batch_params((thetas.cpu(), None))[0]
    n = len(state)
    errs = dict(obs=0.0, action=0.0, state=0.0, reward=0.0)
    ties = flips = 0
    discrete = env.discrete_action
    for step in recs:
        s, obs, a, ns, r = (type(state)(*step[:n]), step[n], step[n + 1], step[n + 2:2 * n + 2], step[-1])
        obs_c = env.observe(s)
        errs["obs"] = max(errs["obs"], float((obs_c - obs).abs().max()))
        if discrete:
            scores = model.batch_scores_parts(cpu_parts, obs_c)
            top2 = scores.topk(2, dim=-1).values
            near = (top2[:, 0] - top2[:, 1]) <= 1e-5 * top2[:, 0].abs().clamp(min=1.0)
            wrong = scores.argmax(-1) != a
            ties += int(near.sum())
            flips += int((wrong & ~near).sum())
        else:
            errs["action"] = max(errs["action"], float((model.batch_act_parts(cpu_parts, obs_c) - a).abs().max()))
        ns_c, r_c, _ = env.step(s, a)
        for x, y in zip(ns_c, ns):
            if x.is_floating_point():
                errs["state"] = max(errs["state"], float((x - y).abs().max()))
            else:
                require(torch.equal(x, y), "teacher-forced: a discrete state field differs")
        errs["reward"] = max(errs["reward"], float((r_c - r).abs().max()))
    out = dict(members=int(thetas.shape[0]), steps=len(recs), near_ties=ties, action_flips=flips, **errs)
    for k, tol in (("obs", 1e-5), ("action", 1e-5), ("state", 1e-4), ("reward", 1e-4)):
        require(errs[k] <= tol, f"teacher-forced: card vs CPU {k} max abs err {errs[k]} > {tol}")
    require(flips == 0, f"teacher-forced: {flips} actions differ away from a near tie")
    return out


def device_ga_case(device, table, cpu_table, name: str, algo: str, generations: int, overrides=None,
                   replay_tol=None, forced_steps: int = 0) -> dict:
    """``generations`` of ``algo`` on a device-env configuration through the
    loader; seconds, env steps/s and rounds a generation; with
    ``replay_tol``, the first fitness pass replayed on the CPU and its
    first round teacher-forced for ``forced_steps`` steps."""
    import torch

    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / name).read_text())
    tr = config.load_experiment(exp, device=device, algo=algo, noise_table=table, overrides=overrides)
    rec = DrawRecorder(tr)
    cfg = tr.config
    print(f"{name} --algo {algo}: {type(tr.env).__name__} {type(tr.model).__name__} D={tr.model.num_params} "
          f"{json.dumps(dataclasses.asdict(cfg))}", flush=True)
    rows = []
    for _ in range(generations):
        before, rounds0, starts0 = tr.state.timesteps_so_far, len(rec.offspring), len(rec.starts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        steps = tr.state.timesteps_so_far - before
        rows.append(dict(seconds=sec, env_steps=steps, env_steps_per_s=steps / sec,
                         fitness_rounds=len(rec.offspring) - rounds0, ladder_rounds=len(rec.starts) - starts0 -
                         (len(rec.offspring) - rounds0), best=float(tr.state.population[0].fitness)))
    st = tr.state
    lens = sorted({len(o.seeds) for o in st.population})
    require(st.it == generations and len(st.population) == cfg.population_size, f"{name} {algo}: generations")
    require(all(math.isfinite(o.fitness) for o in st.population), f"{name} {algo}: non-finite fitness")
    styled = all(isinstance(s, int) for o in st.population for s in o.seeds[1:]) if cfg.genome_style == "cpu" else \
        all(isinstance(s, tuple) for o in st.population for s in o.seeds[1:])
    require(styled, f"{name} {algo}: chains are not {cfg.genome_style}-style")
    with_parents = algo == "ga" and cfg.selection_threshold > 0
    require(lens == ([1, 2] if with_parents and generations == 2 else [1]), f"{name} {algo}: chain lengths {lens}")
    out = dict(config=name, algo=algo, overrides=overrides or {}, genome_style=cfg.genome_style,
               population=cfg.population_size, eval_batch=cfg.eval_batch, generations=rows, chain_lengths=lens)
    if replay_tol is not None:
        out["card_vs_cpu_free_running"] = replay_first_pass_on_cpu(tr, rec, cpu_table, replay_tol)
        out["card_vs_cpu_teacher_forced"] = teacher_forced_first_round(tr, rec, forced_steps)
    print("device_ga_run " + json.dumps(out), flush=True)
    return out


def run_device_ga(device, table) -> list:
    """The device arm: es_gym_config.json whole as a GA (CartPole,
    population 5000, cutoff 5000, GPU-style chains, the 10 × 30 + 200
    ladder); maze_es.json as a GA (CPU-style chains, 512 members, 400
    steps, two generations) and as RS (one generation); the maze GA with
    ``eval_batch`` 128 (four rounds a generation). The first fitness pass
    of the CartPole GA and the maze GA replayed on the CPU, and its first
    round teacher-forced (``teacher_forced_first_round``)."""
    import torch

    from deep_neuroevolution_torch.ops.noise import NoiseTable

    cpu_table = NoiseTable(table.noise.cpu())
    try:
        runs = [
            device_ga_case(device, table, cpu_table, "es_gym_config.json", "ga", 1, replay_tol=0.0, forced_steps=500),
            device_ga_case(device, table, cpu_table, "maze_es.json", "ga", 2, replay_tol=1e-3, forced_steps=400),
            device_ga_case(device, table, cpu_table, "maze_es.json", "rs", 1),
            device_ga_case(device, table, cpu_table, "maze_es.json", "ga", 1, overrides={"eval_batch": 128}),
        ]
    finally:
        del cpu_table
    cart, eb = runs[0], runs[3]
    require(cart["generations"][0]["ladder_rounds"] == 2, "CartPole GA: the ladder is not one validation round "
            "(10 × 30 episodes) and one test round (200)")
    rounds = eb["generations"][0]["fitness_rounds"]
    require(rounds == 4, f"eval_batch 128: {rounds} fitness rounds of 512 members")
    torch.cuda.empty_cache()
    return runs


# phase 22: phase 4's cut of es_atari_config.json on each of the engine's
# obs modes, one trainer a mode, the timed generations in turns
OBS_MODES = ("gray", "indexed", "preproc")
OBS_TURNS = ("gray", "indexed", "preproc", "preproc", "indexed", "gray")


def run_obs_modes(device) -> dict:
    """Phase 4's cut on each ``obs_mode``, one trainer a mode: a warm-up
    generation each, then one timed generation a turn of ``OBS_TURNS``
    (each mode twice, the order reversed the second time): seconds,
    frames/s, the bytes uploaded a slot-step (every ``_frames_to`` call's
    bytes over its rows); K1 and K2 must launch in each. Then the card's
    preprocessing of each mode's engine frames against the CPU's: 'preproc'
    bit for bit (one exact scale), 'gray' and 'indexed' within 1e-6 (cuBLAS
    sums the resize in another order). Returns, by mode, its readings."""
    import torch

    from deep_neuroevolution_torch.algos import rollout_host
    from deep_neuroevolution_torch.envs.preprocess import preprocess_obs
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    upload = dict(bytes=0, rows=0)
    real = rollout_host._frames_to

    def counted(frames, dev):
        upload["bytes"] += frames.nbytes
        upload["rows"] += frames.shape[0]
        return real(frames, dev)

    trainers, runs = {}, {m: [] for m in OBS_MODES}
    try:
        for mode in OBS_MODES:
            over = {**SMOKE_OVERRIDES, "env_kwargs": {**SMOKE_OVERRIDES["env_kwargs"], "obs_mode": mode}}
            trainers[mode] = config.load_experiment(exp, device=device, overrides=over)
            trainers[mode].train_step()  # warm-up
        rollout_host._frames_to = counted
        for mode in OBS_TURNS:
            tr = trainers[mode]
            upload.update(bytes=0, rows=0)
            zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = tr.train_step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, steps = read_counters(), int(st.lengths.sum())
            run = dict(obs_mode=mode, seconds=seconds, timesteps=steps, eval_timesteps=int(st.eval_lengths.sum()),
                       frames_per_s=4 * steps / seconds, upload_bytes=upload["bytes"], slot_steps=upload["rows"],
                       bytes_per_slot_step=upload["bytes"] / max(upload["rows"], 1),
                       k1=launches["population_linear"], k2=launches["noise_gradient"], k1_by_batch=by_batch_k1())
            print("es_obs_mode_generation " + json.dumps(run), flush=True)
            require(run["k1"] > 0 and run["k2"] == 1, f"{mode}: K1 {run['k1']}, K2 {run['k2']} launches")
            require(upload["rows"] >= steps + run["eval_timesteps"], f"{mode}: {upload['rows']} slot-steps uploaded")
            require(bool(np.isfinite(st.returns).all()) and bool(torch.isfinite(tr.theta).all()), f"{mode}: not finite")
            runs[mode].append(dict(run, pairs=int(st.returns.shape[0]), D=tr.model.num_params))
        rollout_host._frames_to = real
        for mode, tr in trainers.items():
            frames = tr.env.observe()
            card = preprocess_obs(torch.from_numpy(frames).to(device), mode).cpu()
            err = float((card - preprocess_obs(torch.from_numpy(frames), mode)).abs().max())
            require(err <= (0.0 if mode == "preproc" else 1e-6), f"{mode}: card preprocessing vs the CPU's: {err}")
            runs[mode][0]["preprocess_card_vs_cpu"] = err
    finally:
        rollout_host._frames_to = real
        for tr in trainers.values():
            tr.close()
    return runs


# phase 23: the counter-based and device-built noise sources
VIRTUAL_GRAD_PAIRS = (256, 2560)  # the main path's pairs a generation, and frostbite_es.json's
VIRTUAL_CPU_PAIRS = 8  # the gradient's card-vs-CPU check, cut to these pairs
NOISE_MODES = ("virtual", "device")


def synced_seconds(fn):
    """(fn's result, its wall seconds with the card synced on both ends)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_virtual_rows(device, dim: int) -> dict:
    """VirtualNoise rows on the card against the CPU's: the threefry words
    equal, the normals within 1e-6 (both run the same torch ops; float64
    log1p may round otherwise by an ulp)."""
    import torch

    from deep_neuroevolution_torch.ops import noise

    vn = noise.VirtualNoise.from_seed(device=device)
    ids = torch.tensor([0, 1, 12345, 2**31 - 1])
    k0, k1 = noise.fold_in_batch(vn.key, ids)
    card_bits = noise._counter_bits(k0[:, None].to(device), k1[:, None].to(device), 0, dim, device).cpu()
    cpu_bits = noise._counter_bits(k0[:, None], k1[:, None], 0, dim, torch.device("cpu"))
    require(torch.equal(card_bits, cpu_bits), "VirtualNoise: the card's threefry words differ from the CPU's")
    card, cpu = vn.get_batch(ids, dim).cpu(), vn.to("cpu").get_batch(ids, dim)
    err = float((card - cpu).abs().max())
    require(err <= 1e-6, f"VirtualNoise: card rows vs the CPU's {err} > 1e-6")
    return dict(rows=int(ids.numel()), dim=dim, bits_equal=True, normals_max_abs_err=err,
                normals_differing=int((card != cpu).sum()))


def check_from_key(device) -> dict:
    """The 250M-float ``noise: device`` table built on the card, timed; its
    first 2^20 floats against the CPU's, its moments."""
    import torch

    from deep_neuroevolution_torch.ops import noise

    key = noise.prng_key(123)
    table, seconds = synced_seconds(lambda: noise.NoiseTable.from_key(key, device=device))
    head = noise.normal(key, 1 << 20, device="cpu")
    err = float((table.noise[: 1 << 20].cpu() - head).abs().max())
    mean, std = float(table.noise.mean()), float(table.noise.std())
    require(table.size == noise.DEFAULT_COUNT and bool(torch.isfinite(table.noise).all()), "from_key: not finite")
    require(err <= 1e-6 and abs(mean) < 1e-3 and abs(std - 1) < 1e-3, f"from_key: err {err}, mean {mean}, std {std}")
    return dict(count=table.size, seconds=seconds, head_max_abs_err=err, mean=mean, std=std)


def time_virtual_gradient(device, dim: int) -> dict:
    """The VirtualNoise gradient (rows regenerated ``grad_chunk`` = 256 at a
    time, no K2) at each of ``VIRTUAL_GRAD_PAIRS`` × ``dim`` on the card,
    one call each (CUDA events); the first ``VIRTUAL_CPU_PAIRS`` pairs
    against the CPU within 1e-5·max|g|."""
    import torch

    from deep_neuroevolution_torch.ops import fitness, noise

    vn = noise.VirtualNoise.from_seed(device=device)
    gen = torch.Generator().manual_seed(3)
    out = {}
    for pairs in VIRTUAL_GRAD_PAIRS:
        idx = vn.sample_index_batch(gen, dim, pairs)
        w = torch.randn(pairs, generator=gen)
        g = fitness.gradient_from_noise(vn, idx, w.to(device), dim)  # also the warm-up
        out[f"ms_{pairs}"] = cuda_ms(lambda: fitness.gradient_from_noise(vn, idx, w.to(device), dim), 1, warmup=0)
        require(bool(torch.isfinite(g).all()), f"VirtualNoise gradient at {pairs} pairs is not finite")
    idx, w = idx[:VIRTUAL_CPU_PAIRS], w[:VIRTUAL_CPU_PAIRS]
    card = fitness.gradient_from_noise(vn, idx, w.to(device), dim).cpu()
    cpu = fitness.gradient_from_noise(vn.to("cpu"), idx, w, dim)
    err, tol = float((card - cpu).abs().max()), 1e-5 * float(cpu.abs().max())
    require(err <= tol, f"VirtualNoise gradient card vs CPU {err} > {tol}")
    return dict(out, dim=dim, cpu_pairs=VIRTUAL_CPU_PAIRS, max_abs_err=err, tol=tol)


def run_es_noise_modes(device, generations: int = 2) -> dict:
    """Phase 4's cut of es_atari_config.json on ``noise: virtual`` and on
    ``noise: device`` (a 25M-float table built on the card), through the
    loader: ``generations`` generations each, every one with K1 launching
    and K2 launching 0 times (virtual) or once (device)."""
    import torch

    from deep_neuroevolution_torch.ops import noise
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / "es_atari_config.json").read_text())
    runs = {}
    for mode in NOISE_MODES:
        tr, load_s = synced_seconds(lambda: config.load_experiment(exp, device=device,
                                                                   overrides={**SMOKE_OVERRIDES, "noise": mode}))
        want = noise.VirtualNoise if mode == "virtual" else noise.NoiseTable
        require(type(tr.noise) is want and tr.noise.size == SMOKE_OVERRIDES["noise_size"], f"{mode}: {tr.noise}")
        rows = []
        try:
            with record_k2() as seen:
                for _ in range(generations):
                    zero_counters()
                    st, seconds = synced_seconds(tr.train_step)
                    launches, steps = read_counters(), int(st.lengths.sum())
                    rows.append(dict(seconds=seconds, timesteps=steps, frames_per_s=4 * steps / seconds,
                                     k1=launches["population_linear"], k2=launches["noise_gradient"]))
                    require(rows[-1]["k1"] > 0, f"ES on noise {mode}: K1 never launched")
                    require(rows[-1]["k2"] == (0 if mode == "virtual" else 1),
                            f"ES on noise {mode}: K2 {rows[-1]['k2']}")
                    require(bool(np.isfinite(st.returns).all()) and bool(torch.isfinite(tr.theta).all()),
                            f"ES on noise {mode}: not finite")
            require(len(seen) == sum(r["k2"] for r in rows), f"ES on noise {mode}: {len(seen)} K2 calls recorded")
            # K2 on the card-built table, the first generation's offsets and weights, against its plain version
            k2_err = check_k2(tr.noise.noise, *seen[0], tr.model.num_params) if seen else None
        finally:
            tr.close()
        runs[mode] = dict(load_seconds=load_s, generations=rows, k1_by_batch=by_batch_k1(), k2_max_abs_err=k2_err)
        print(f"es_noise_{mode} " + json.dumps(runs[mode]), flush=True)
        del tr
        torch.cuda.empty_cache()
    return runs


def run_maze_ga_virtual(device, generations: int = 2) -> dict:
    """maze_es.json as a GA (CPU-style chains) on ``noise: virtual``:
    every cached parent's θ against its chain rebuilt whole from the
    VirtualNoise (one rounding a step against two: within 1e-6)."""
    from deep_neuroevolution_torch.ops import noise
    from deep_neuroevolution_torch.utils import checkpoint, config

    exp = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    tr = config.load_experiment(exp, device=device, algo="ga", overrides={"noise": "virtual"})
    require(isinstance(tr.noise, noise.VirtualNoise), "maze GA: not on a VirtualNoise")
    seconds = [synced_seconds(tr.train_step)[1] for _ in range(generations)]
    gaps = [float((checkpoint.theta_from_seed_chain(tr.model, tr.noise, list(seeds), "cpu", tr.config.noise_stdev)
                   - cached).abs().max())
            for seeds, cached in zip(tr.cached_parent_seeds, tr.cached_parent_thetas)]
    out = dict(seconds=seconds, population=tr.config.population_size, parents=len(gaps),
               max_chain=max(len(s) for s in tr.cached_parent_seeds), cache_vs_whole_chain_max_abs=max(gaps))
    print("maze_ga_virtual " + json.dumps(out), flush=True)
    require(out["max_chain"] == generations and max(gaps) <= 1e-6, f"maze GA on virtual noise: {out}")
    return out


# phase 24: the DQN family's other fields and BNDQN at B=128 on ToyCatch frames
VARIANTS = (("SmallDQN", "tanh"), ("VirtualBNDQN", "elu"), ("LargeDQN", "tanh"), ("BNDQN", "relu"))
VARIANT_B = 128  # an ES round's pipeline group
CHUNK_CASE = (256, 64)  # LargeDQN members and the chunk of prepare_batch_params_chunked


def near_members(model, B: int, device):
    """B members near a normc init: θ₀ + 0.02·ε."""
    import torch

    gen = torch.Generator().manual_seed(B)
    base = model.init_theta(gen, device)
    return base[None] + 0.02 * torch.randn((B, model.num_params), generator=gen).to(device)


def variant_scores(model, thetas, obs, ref):
    """Scores on the split route (VBN stats from ``ref``), all on
    ``thetas``' device, and the prepared parts' route."""
    ctx = model.batch_ref_stats(thetas, ref) if model.needs_ref_batch else None
    parts, ctx = model.prepare_batch_params((thetas, ctx))
    route = "K3" if "__fused_lg__" in parts else "fused" if "__fused__" in parts else "split"
    return model.batch_scores_parts(parts, obs, ctx), route


def run_model_variants(device) -> dict:
    """A tanh SmallDQN, an elu VirtualBNDQN, a tanh LargeDQN and a BNDQN at
    B=128 on ToyCatch frames, card against CPU within phase 4's tolerance
    (1e-3·max(1, max|score|), argmax equal but at a near tie), each on the
    split route with K1 launching and K3, K4, K5, K6 not (BNDQN: no kernel,
    its fc a plain batched product); a forced fused route on tanh raises;
    ``prepare_batch_params_chunked`` against the whole prepare."""
    import torch

    from deep_neuroevolution_torch import models
    from deep_neuroevolution_torch.algos.rollout_host import collect_ref_batch_host
    from deep_neuroevolution_torch.envs.atari import AtariEnv

    env = AtariEnv("toy", batch_size=VARIANT_B)
    try:
        frames = collect_ref_batch_host(env, 11, device, batch_size=VARIANT_B + 16)
    finally:
        env.close()
    obs, ref = frames[:VARIANT_B], frames[VARIANT_B:]
    rows = []
    for name, nonlin in VARIANTS:
        model = getattr(models, name)(num_actions=4, nonlin_type=nonlin)
        thetas = near_members(model, VARIANT_B, device)
        zero_counters()
        (card, route), _ = synced_seconds(lambda: variant_scores(model, thetas, obs, ref))
        launches = read_counters()
        cpu, _ = variant_scores(model, thetas.cpu(), obs.cpu(), ref.cpu())
        card = card.cpu()
        err, tol = float((card - cpu).abs().max()), 1e-3 * max(1.0, float(cpu.abs().max()))
        clear = check_top_actions(card, cpu, 2 * tol, f"{name} {nonlin}")
        rows.append(dict(model=name, nonlin=nonlin, B=VARIANT_B, route=route, k1=launches["population_linear"],
                         others={k: v for k, v in launches.items() if not k.startswith("population_linear")},
                         max_abs_err=err, tol=tol, clear_rows=clear))
        print("model_variant " + json.dumps(rows[-1]), flush=True)
        require(route == "split" and err <= tol, f"{name} {nonlin}: route {route}, card vs CPU {err} > {tol}")
        require(rows[-1]["k1"] == (0 if name == "BNDQN" else 1), f"{name} {nonlin}: K1 launched {rows[-1]['k1']}")
        require(not any(rows[-1]["others"].values()), f"{name} {nonlin}: another kernel launched")
        del thetas
    raised = []
    for cls, kw in ((models.SmallDQN, dict(conv_impl="fused")), (models.LargeDQN, dict(forward_impl="fused")),
                    (models.VirtualBNDQN, dict(forward_impl="fused1")), (models.VirtualBNDQN, dict(forward_impl="fused"))):
        try:
            cls(num_actions=4, nonlin_type="tanh", **kw)
        except ValueError:
            raised.append(f"{cls.__name__} {kw}")
    require(len(raised) == 4, f"a forced fused route on tanh did not raise: {raised}")
    torch.cuda.empty_cache()
    return dict(rows=rows, fused_on_tanh_raised=raised, chunked=check_chunked_prepare(device))


def check_chunked_prepare(device) -> list:
    """``prepare_batch_params_chunked`` of LargeDQN members (the card's
    'auto' route, K3's layout) against the whole prepare, float32 and
    bfloat16: every tensor equal bit for bit; each one's peak device memory
    above its input."""
    import torch

    from deep_neuroevolution_torch import models

    B, chunk = CHUNK_CASE
    out = []
    for dt in ("float32", "bfloat16"):
        model = models.LargeDQN(num_actions=4, compute_dtype=dt)
        thetas = near_members(model, B, device)
        peaks, parts = [], []
        for prep in (lambda: model.prepare_batch_params((thetas, None)),
                     lambda: model.prepare_batch_params_chunked((thetas, None), chunk)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            parts.append(prep()[0]["__fused_lg__"])
            torch.cuda.synchronize()
            peaks.append((torch.cuda.max_memory_allocated() - base) / 1e9)
        whole, chunked = parts
        equal = whole.keys() == chunked.keys() and all(torch.equal(whole[k], chunked[k]) for k in whole)
        out.append(dict(dtype=dt, B=B, chunk=chunk, equal=equal, whole_peak_gb=peaks[0], chunked_peak_gb=peaks[1],
                        theta_gb=thetas.numel() * 4 / 1e9))
        print("chunked_prepare " + json.dumps(out[-1]), flush=True)
        require(equal, f"chunked prepare ({dt}) differs from the whole prepare")
        del thetas, parts, whole, chunked
        torch.cuda.empty_cache()
    return out


# phase 25: replays through ``main replay``
REPLAY_EPISODES = 8
REPLAY_ENV = {"batch_size": 8}
RECORD_CALLS = 400  # forwards recorded for the teacher-forced check


def cli_json(argv) -> dict:
    """``main`` on ``argv``; its stats line, parsed."""
    import io

    from deep_neuroevolution_torch import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    print(buf.getvalue(), end="", flush=True)
    require(rc == 0, f"main {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@contextlib.contextmanager
def recording_scores(cls, calls: list, method: str = "batch_scores_parts"):
    """Every ``cls.<method>(parts, obs, ...)`` call's frames and scores,
    copied to the CPU (the first ``RECORD_CALLS``)."""
    real = getattr(cls, method)

    def recorded(self, parts, obs, *rest, **kw):
        y = real(self, parts, obs, *rest, **kw)
        if len(calls) < RECORD_CALLS:
            calls.append((obs.cpu(), y.cpu()))
        return y

    setattr(cls, method, recorded)
    try:
        yield calls
    finally:
        setattr(cls, method, real)


def vbn_teacher_forced(model, theta, ref_batch, calls: list, what: str, rows=None) -> tuple:
    """Each recorded card forward of the VBN-DQN ``theta`` (frames and
    scores, from ``recording_scores``; its first ``rows`` slots, or all)
    again on the CPU from the card's frames, within phase 4's
    1e-3·max(1, max|score|), the argmax equal but at a near tie; returns
    (max abs error, the largest tolerance, near ties)."""
    stats = model.batch_ref_stats(theta[None], ref_batch)
    err = tol = 0.0
    near = 0
    for obs, scores in calls:
        obs, scores = obs[:rows], scores[:rows]
        n = obs.shape[0]
        ctx = type(stats)(*(tuple(x.expand(n, -1) for x in f) for f in stats))
        parts, ctx = model.prepare_batch_params((theta[None].expand(n, -1), ctx))
        ref = model.batch_scores_parts(parts, obs, ctx)
        t = 1e-3 * max(1.0, float(ref.abs().max()))
        err, tol = max(err, float((scores - ref).abs().max())), max(tol, t)
        top2 = ref.topk(2, dim=-1).values
        near += int(((top2[:, 0] - top2[:, 1]) <= 2 * t).sum())
        check_top_actions(scores, ref, 2 * t, what)
    return err, tol, near


def replay_toy_policy(device, path: str) -> dict:
    """``main replay --snapshot`` of phase 4's policy file, 8 episodes on 8
    engine slots, on the card (K1 must launch) and on the CPU with the
    same engine episode seeds. Teacher-forced: every recorded card forward
    again on the CPU from the card's frames, within phase 4's tolerance,
    the argmax equal but at a near tie. The returns equal the CPU's, or a
    near tie was recorded (the free-running replays part there)."""
    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.utils import checkpoint, viz

    argv = ["replay", "--snapshot", path, "--env", "toy", "--episodes", str(REPLAY_EPISODES),
            "--env_kwargs", json.dumps(REPLAY_ENV)]
    calls = []
    zero_counters()
    with recording_scores(VirtualBNDQN, calls):
        card, seconds = synced_seconds(lambda: cli_json(argv + ["--device", str(device)]))
    launches = read_counters()
    cpu = viz.replay_snapshot(path, env_id="toy", episodes=REPLAY_EPISODES, env_kwargs=REPLAY_ENV, device="cpu")
    model, theta, payload = checkpoint.load_policy_snapshot(path, device="cpu")
    err, tol, near = vbn_teacher_forced(model, theta, payload["ref_batch"], calls, "replay teacher-forced")
    equal = card["returns"] == cpu["returns"] and card["lengths"] == cpu["lengths"]
    out = dict(seconds=seconds, k1=launches["population_linear"], k1_by_batch=by_batch_k1(),
               returns_card=card["returns"], returns_cpu=cpu["returns"], lengths_card=card["lengths"],
               free_running_equal=equal, forwards_recorded=len(calls), teacher_forced_max_abs_err=err,
               teacher_forced_tol=tol, near_ties=int(near))
    print("replay_toy " + json.dumps(out), flush=True)
    require(launches["population_linear"] > 0, "replay: K1 never launched")
    require(err <= tol, f"replay teacher-forced: card vs CPU {err} > {tol}")
    require(equal or near > 0, "replay: the returns part from the CPU's with no near tie recorded")
    require(len(card["returns"]) == REPLAY_EPISODES and all(math.isfinite(r) for r in card["returns"]), "replay: returns")
    return out


def replay_large_chain(device) -> dict:
    """``main replay --seeds`` of a GPU-style LargeDQN chain (the model of
    ga_atari_config.json, at its widths) on a 25M-float table, 8 episodes
    on 8 engine slots: K3 must launch (the card's 'auto' route). Every
    recorded K3 forward again on the CPU (its plain K3, θ rebuilt from the
    chain on a CPU table) from the card's frames, within phase 5's
    1e-3·max|score|, the argmax equal but at a near tie; then K3 at each
    batch size the replay launched it with, against its plain version on
    the card and timed (phase 7's check)."""
    import torch

    from deep_neuroevolution_torch import models
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops.noise import NoiseTable
    from deep_neuroevolution_torch.utils import checkpoint

    exp = json.loads((ROOT / "configurations" / "ga_atari_config.json").read_text())
    chain = [123, [456, 0.002], [789, 0.002]]
    argv = ["replay", "--seeds", json.dumps(chain), "--model", exp["model"],
            "--model_kwargs", json.dumps({"num_actions": 4}), "--env", "toy", "--episodes", str(REPLAY_EPISODES),
            "--env_kwargs", json.dumps(REPLAY_ENV), "--noise_count", str(GA_OVERRIDES["noise_size"]),
            "--device", str(device)]
    calls = []
    zero_counters()
    with recording_scores(LargeDQN, calls, "batch_scores_fused"):
        stats, seconds = synced_seconds(lambda: cli_json(argv))
    launches = read_counters()
    k3 = kernel_counters()["large_dqn_fused_scores"]
    by_batch = dict(k3.launches_by_batch)
    cls = models.get_model(exp["model"])
    require(issubclass(cls, LargeDQN), f"{exp['model']} is not a LargeDQN")
    model = cls(num_actions=4, forward_impl="fused")  # on the CPU: the plain K3
    theta = checkpoint.theta_from_seed_chain(model, NoiseTable.from_seed(count=GA_OVERRIDES["noise_size"]), chain)
    prepared, na = {}, model.num_actions
    err = tol = 0.0
    near = 0
    for obs, scores in calls:
        n = obs.shape[0]
        if n not in prepared:
            prepared[n] = model.prepare_batch_params((theta[None].expand(n, -1), None))[0]["__fused_lg__"]
        ref, card = model.batch_scores_fused(prepared[n], obs)[:, :na], scores[:, :na]
        t = 1e-3 * float(ref.abs().max())
        err, tol = max(err, float((card - ref).abs().max())), max(tol, t)
        require(float((card - ref).abs().max()) <= t, f"replay of a LargeDQN chain: K3 vs the CPU's plain K3 > {t}")
        top2 = ref.topk(2, dim=-1).values
        near += int(((top2[:, 0] - top2[:, 1]) <= 2 * t).sum())
        check_top_actions(card, ref, 2 * t, "replay of a LargeDQN chain, teacher-forced")
    del prepared
    timed = time_large_fused_by_batch(device, by_batch)
    out = dict(model=exp["model"], seconds=seconds, k3=launches["large_dqn_fused_scores"],
               k3_by_batch={str(b): n for b, n in by_batch.items()}, returns=stats["returns"],
               lengths=stats["lengths"], forwards_recorded=len(calls), teacher_forced_max_abs_err=err,
               teacher_forced_tol=tol, near_ties=near,
               k3_graph_ms_by_batch={str(r["B"]): r["graph_ms"] for r in timed["rows"]},
               k3_bound_ms_by_batch={str(r["B"]): r["bound_ms"] for r in timed["rows"]},
               k3_plain_max_abs_err_by_batch={str(r["B"]): r["max_abs_err"] for r in timed["rows"]})
    print("replay_large_chain " + json.dumps(out), flush=True)
    require(out["k3"] > 0, "replay of a LargeDQN chain: K3 never launched")
    require(len(calls) == min(out["k3"], RECORD_CALLS), f"recorded {len(calls)} of {out['k3']} K3 forwards")
    require(all(math.isfinite(r) for r in stats["returns"]) and min(stats["lengths"]) >= 1, "replay: returns")
    torch.cuda.empty_cache()
    return out


def replay_maze_policy(device, path: str, work: str) -> dict:
    """``main replay --snapshot`` of phase 14's maze policy on the card
    (``rollout_batch_scan``'s graphs) and on the CPU: the .npz keys equal;
    that recording teacher-forced on the CPU (phase 14's tolerances: within
    1e-5 / 1e-4) from an eager recording of the same episodes on the card;
    the card's graphed trajectories against that eager recording, and the
    CPU's free-running ones against them, each within 1e-3 (the graphs
    read θ through a broadcast view, the recording a copy, so cuBLAS may
    sum otherwise)."""
    from deep_neuroevolution_torch.utils import checkpoint, config, viz

    card_npz, cpu_npz = str(Path(work) / "maze_card.npz"), str(Path(work) / "maze_cpu.npz")
    argv = ["replay", "--snapshot", path, "--env", "maze", "--episodes", str(REPLAY_EPISODES),
            "--save_frames", card_npz, "--device", str(device)]
    card, seconds = synced_seconds(lambda: cli_json(argv))
    cpu = viz.replay_snapshot(path, env_id="maze", episodes=REPLAY_EPISODES, save_frames=cpu_npz, device="cpu")
    cz, pz = np.load(card_npz), np.load(cpu_npz)
    require(sorted(cz.files) == sorted(pz.files) == ["bc_trajectory", "lengths", "returns"], "maze replay: .npz keys")
    model, theta, _ = checkpoint.load_policy_snapshot(path, device=device)
    forced = maze_teacher_forced(config.resolve_env("maze"), model, theta[None].expand(REPLAY_EPISODES, -1).contiguous(),
                                 "maze_replay")
    graph_vs_eager = float(np.abs(cz["bc_trajectory"] - forced["positions"].numpy()).max())
    free = float(np.abs(cz["bc_trajectory"] - pz["bc_trajectory"]).max())
    out = dict(seconds=seconds, returns_card=card["returns"], returns_cpu=cpu["returns"],
               trajectory=list(cz["bc_trajectory"].shape), graph_vs_eager_max_abs=graph_vs_eager,
               free_running_cpu_max_abs=free, **{k: v for k, v in forced.items() if k != "positions"})
    print("replay_maze " + json.dumps(out), flush=True)
    require(graph_vs_eager <= 1e-3, f"maze replay: graphed trajectories vs eager {graph_vs_eager} > 1e-3")
    require(free <= 1e-3, f"maze replay: the CPU's free-running trajectories {free} > 1e-3")
    return out


# ------------------------------------------------------------ scale-out

POD_TABLE = 25_000_000  # phase 27's table cut (each rank builds its own)
# phase 27: name → (configuration, algo, overrides, generations); the device
# pods on the maze, the host pods on phase 4's cut of es_atari_config.json
# (K1, K2), a cut of ga_atari_config.json (K3: 256 members, cutoff 200) and
# frostbite_nses.json (K1, K2), each table cut to 25M floats
POD_CASES = {
    "maze_es": ("maze_es.json", None, {"noise_size": POD_TABLE}, 2),
    "maze_nses": ("maze_nses.json", None, {"noise_size": POD_TABLE}, 2),
    "es_atari": ("es_atari_config.json", None, SMOKE_OVERRIDES, 2),
    "ga_atari": ("ga_atari_config.json", "ga", {**GA_OVERRIDES, "population_size": 256}, 1),
    "frostbite_nses": ("frostbite_nses.json", None, {"noise_size": POD_TABLE}, 2),
}
POD_KERNELS = {"es_atari": ("population_linear", "noise_gradient"), "ga_atari": ("large_dqn_fused_scores",),
               "frostbite_nses": ("population_linear", "noise_gradient"), "maze_es": ("noise_gradient",),
               "maze_nses": ("noise_gradient",)}


def digest(x) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()[:16]


def pod_summary(tr, st) -> dict:
    """A generation's outputs as numpy (θ and the GA's parents as digests
    beside θ itself where it is small)."""
    if hasattr(st, "population"):  # GA
        return dict(fitness=np.array([o.fitness for o in st.population]), seeds=[o.seeds for o in st.population],
                    elite=st.elite.seeds, parents=digest(tr.cached_parent_thetas.cpu().numpy()))
    rec = dict(returns=st.returns, lengths=st.lengths, theta=tr.theta.cpu().numpy(),
               theta_digest=digest(tr.theta.cpu().numpy()))
    if hasattr(st, "novelty"):
        rec.update(novelty=st.novelty, parent=st.parent)
    else:
        rec.update(bc=st.bc, eval_returns=st.eval_returns)
    return rec


def pod_generations(tr, generations: int) -> list:
    """Each generation's outputs, seconds (synced), seconds in collectives
    and kernel launches."""
    import torch

    sync = torch.cuda.synchronize if tr.device.type == "cuda" else (lambda: None)
    out = []
    for _ in range(generations):
        zero_counters()
        c0 = collective_seconds(tr)
        sync()
        t0 = time.perf_counter()
        st = tr.train_step()
        sync()
        sec = time.perf_counter() - t0
        out.append(dict(pod_summary(tr, st), seconds=sec, collective_seconds=collective_seconds(tr) - c0,
                        launches=read_counters()))
    return out


def collective_seconds(tr) -> float:
    """Seconds a pod trainer has spent in collectives (0 for a single one)."""
    pod = getattr(tr, "pod", None)
    return pod.seconds if pod is not None else 0.0


def load_pod_case(name: str, device, extra=None, **kw):
    from deep_neuroevolution_torch.utils import config

    file, algo, overrides, _ = POD_CASES[name]
    exp = json.loads((ROOT / "configurations" / file).read_text())
    return config.load_experiment(exp, overrides={**overrides, **(extra or {})}, device=device, algo=algo, **kw)


def pod_child(rank: int, world: int, store: str, out_dir: str, device: str = "cuda:0") -> None:
    """A rank of phase 27: gloo on the shared card; every case of
    ``POD_CASES``, then one ``main train --log_dir`` of maze_es.json (rank 1
    logs to its own directory, which must stay unmade)."""
    import pickle

    import torch

    from deep_neuroevolution_torch import main as cli
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.parallel import distributed, mesh

    mesh.PopGroup.timed = True  # the collectives' seconds
    device = torch.device(device)
    if device.type == "cuda":
        _cuda_build.load()  # the library phase 1 built
    distributed.init_multihost(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                               device=device)
    out = Path(out_dir)
    res = {"probe": {}}
    for op, fn in (("all_gather", lambda t: distributed.all_gather(t)),
                   ("all_reduce", lambda t: distributed.all_reduce_sum(t))):
        t = torch.full((3,), float(rank + 1), device=device)
        got = fn(t)
        res["probe"][op] = dict(device=str(got.device), values=got.cpu().tolist())
    for name, (_, _, _, gens) in POD_CASES.items():
        tr = load_pod_case(name, device)
        try:
            res[name] = dict(type=type(tr).__name__, runs=pod_generations(tr, gens))
        finally:
            tr.close()
        del tr
        torch.cuda.empty_cache()
    log_dir = out / ("cli_logs" if rank == 0 else f"cli_logs_rank{rank}")
    cli.main(["train", "--device", str(device), "--exp_file", str(ROOT / "configurations" / "maze_es.json"),
              "--iterations", "1", "--log_dir", str(log_dir), "--overrides", json.dumps({"noise_size": POD_TABLE})])
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    distributed.shutdown()


def same_outputs(want: dict, got: dict, what: str, theta_atol: float = 0.0) -> float:
    """Equal outputs (``theta`` within ``theta_atol``); returns θ's max
    difference."""
    diff = 0.0
    for k, v in want.items():
        if k in ("seconds", "collective_seconds", "launches") or (k == "theta_digest" and theta_atol):
            continue
        if k == "theta":
            diff = float(np.abs(got[k] - v).max())
            require(diff <= theta_atol, f"{what}: θ differs by {diff} (allowed {theta_atol})")
        elif isinstance(v, np.ndarray):
            require(v.shape == got[k].shape and bool(np.array_equal(v, got[k])), f"{what}: {k} differs")
        else:
            require(v == got[k], f"{what}: {k} differs")
    return diff


def run_pod_world_of_one(device, table, backend: str = "nccl") -> dict:
    """Phase 26: a torch.distributed world of one rank on NCCL; one
    generation of maze_es.json at full size through PodESTrainer (``pod:
    true``) and the same through ESTrainer, the same seed and table; then
    the GA on the maze the same way."""
    import torch

    from deep_neuroevolution_torch.parallel import distributed, mesh
    from deep_neuroevolution_torch.utils import config

    mesh.PopGroup.timed = True  # the collectives' seconds
    exp = json.loads((ROOT / "configurations" / "maze_es.json").read_text())
    store = tempfile.NamedTemporaryFile(prefix="nevo_pod_store_", delete=False).name
    os.unlink(store)
    distributed.init_multihost(backend=backend, init_method=f"file://{store}", world_size=1, rank=0, device=device)
    rows = {}
    try:
        require(distributed.backend() == backend, f"backend {distributed.backend()}")
        for algo in ("es", "ga"):
            trs = {}
            for arm, pod in (("pod", True), ("single", False)):
                trs[arm] = config.load_experiment(exp, overrides={"pod": pod}, device=device, algo=algo,
                                                  noise_table=table)
                require(type(trs[arm]).__name__ == ("Pod" if pod else "") + ("ES" if algo == "es" else "GA")
                        + "Trainer", f"phase 26 {algo} {arm}: {type(trs[arm]).__name__}")
            gens = {"pod": [], "single": []}
            for arm in ("pod", "single", "single", "pod"):  # two generations each, in turns
                gens[arm] += pod_generations(trs[arm], 1)
            diff = 0.0
            for g, (p, s) in enumerate(zip(gens["pod"], gens["single"])):
                diff = max(diff, same_outputs(s, p, f"phase 26 {algo} generation {g}", theta_atol=1e-6))
                if algo == "es":
                    require(p["launches"]["noise_gradient"] == 1 == s["launches"]["noise_gradient"],
                            f"phase 26: K2 launched {p['launches']['noise_gradient']} times in the pod")
            rows[algo] = dict(pod_seconds=[p["seconds"] for p in gens["pod"]],
                              single_seconds=[s["seconds"] for s in gens["single"]],
                              collective_seconds=[p["collective_seconds"] for p in gens["pod"]],
                              collectives=trs["pod"].pod.calls, theta_max_diff=diff,
                              launches=gens["pod"][0]["launches"])
            del trs, gens
    finally:
        distributed.shutdown()
    return rows


def run_pod_two_ranks(device) -> dict:
    """Phase 27: two ranks that share the card over gloo, each a child
    process (``chip_smoke.py --pod-rank R``) on the kernel library phase 1
    built; every case against the same case in this process: the host pods
    against their ``host_pod: 2`` emulation and the device pods against
    theirs, bit for bit; the device ES pod against the single trainer whose
    rounds are its blocks (``eval_batch`` 128, the pod's pairs a rank:
    returns bit for bit, θ within float reordering). K1, K2 and K3 must launch in each rank on their
    cases; only rank 0 writes the log directory."""
    import pickle

    import torch

    from deep_neuroevolution_torch.parallel import trainers as pt

    work = Path(tempfile.mkdtemp(prefix="nevo_pod2_"))
    env = {k: v for k, v in os.environ.items() if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*POD_CHILD, "--pod-rank", str(r), "2", str(work / "store"), str(work), str(device)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=700)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    ranks_seconds = time.perf_counter() - t0
    for r, log in enumerate(logs):
        (work / f"rank{r}.log").write_text(log)
    require(all(pr.returncode == 0 for pr in procs),
            "phase 27 ranks failed:\n" + "\n".join(f"-- rank {r}\n{log[-3000:]}" for r, log in enumerate(logs)))
    res = []
    for r in (0, 1):
        with open(work / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    require(not (work / "cli_logs_rank1").exists(), "phase 27: rank 1 wrote its log directory")
    require((work / "cli_logs" / "metrics.jsonl").exists(), "phase 27: rank 0 wrote no log")
    summary = dict(ranks_seconds=ranks_seconds, probe=res[0]["probe"], cases={})
    for name, (_, _, _, gens) in POD_CASES.items():
        host = name not in ("maze_es", "maze_nses")
        t1 = time.perf_counter()
        if host:
            emu = load_pod_case(name, device, {"host_pod": 2})
        else:
            single = load_pod_case(name, device, {"pod": False})
            cls = pt.PodESTrainer if name == "maze_es" else pt.PodNSESTrainer
            emu = cls(single.env, single.model, single.config, optimizer=single.optimizer, noise_table=single.noise,
                      device=device, emulate_procs=2)
            del single
        try:
            want = pod_generations(emu, gens)
            block_pairs = emu._npairs_round() if name == "maze_es" else None
        finally:
            emu.close()
        del emu
        torch.cuda.empty_cache()
        for r in (0, 1):
            require(res[r][name]["type"] == type_name(name), f"phase 27 {name}: rank {r} ran {res[r][name]['type']}")
            for g, (w, got) in enumerate(zip(want, res[r][name]["runs"])):
                same_outputs(w, got, f"phase 27 {name} rank {r} generation {g}")
            for k in POD_KERNELS[name]:
                require(all(run["launches"][k] > 0 for run in res[r][name]["runs"]),
                        f"phase 27 {name}: {k} did not launch in rank {r}")
        row = dict(emulation_seconds=[w["seconds"] for w in want], emulation_seconds_total=time.perf_counter() - t1)
        for r in (0, 1):
            runs = res[r][name]["runs"]
            row[f"rank{r}"] = dict(seconds=[x["seconds"] for x in runs],
                                   collective_share=[x["collective_seconds"] / x["seconds"] for x in runs],
                                   launches=[{k: x["launches"][k] for k in POD_KERNEL_NAMES} for x in runs])
        if name == "maze_es":  # the single trainer whose rounds are the pod's blocks
            single = load_pod_case(name, device, {"pod": False, "eval_batch": block_pairs})
            s = pod_generations(single, 1)[0]  # one generation: θ then differs by float reordering
            del single
            row["single_theta_max_diff"] = same_outputs(s, res[0][name]["runs"][0], "phase 27 maze_es vs single",
                                                        theta_atol=1e-6)
            row["single_seconds"] = s["seconds"]
        summary["cases"][name] = row
    shutil.rmtree(work, ignore_errors=True)
    return summary


POD_KERNEL_NAMES = ("population_linear", "noise_gradient", "large_dqn_fused_scores")
POD_CHILD = [sys.executable, str(Path(__file__).resolve())]  # a phase-27 rank: this script, --pod-rank


def type_name(name: str) -> str:
    base = {"maze_es": "ESTrainer", "maze_nses": "NSESTrainer", "es_atari": "ESTrainer", "ga_atari": "GATrainer",
            "frostbite_nses": "NSESTrainer"}[name]
    return ("Pod" if name.startswith("maze") else "HostPod") + base


# phases 28-29: the vector host engine at the Humanoid's width
HUMANOID, HUMANOID_NS = "humanoid.json", "humanoid_nses.json"
HUMANOID_TABLE = 25_000_000  # phases 28-29's own table: the reference stream's first 25M floats
NS_SLOTS = 1000  # humanoid_nses.json's 1000 episodes in one round (its population; 64 slots would run 64)


class StandInHumanoid:
    """A stand-in for the MuJoCo Humanoid-v5 engine, used only where
    gymnasium and mujoco do not import (the card's machine). It has the
    surface of the port's ``MujocoHostEnv`` that ``rollout_host_vec`` drives,
    at the Humanoid's widths: 348 float32 observations, 17 continuous
    actions in [-0.4, 0.4], a 1000-step cap and the mass centre's (x, y) as
    the final-state BC. Its dynamics are seeded numpy, not physics: a
    hidden state driven by the actions, a height that drifts down with
    noise, the episode over when the height leaves [1, 2] (Humanoid-v5's
    healthy range) or at the cap; reward 5 (alive) + 1.25 · forward
    velocity − 0.1 · |a|². A result on it is a result of the port's path,
    never a Humanoid result."""

    is_host_env = True
    host_obs = "vector"
    env_id = "StandInHumanoid"

    def __init__(self, batch_size: int = 64, bc_mode: str = "final_pos", seed: int = 0, **_):
        from deep_neuroevolution_torch.envs.core import Continuous

        if bc_mode != "final_pos":
            raise ValueError("the stand-in keeps only the final mass centre")
        self.batch_size, self.bc_dim, self.obs_shape = batch_size, 2, (348,)
        self.action_space = Continuous(17, (-0.4,) * 17, (0.4,) * 17)
        self.max_episode_steps = self.default_timestep_cutoff = 1000
        rs = np.random.RandomState(12345)  # the dynamics, the same in every pool
        self._M = rs.randn(64, 64) * 0.9 / 8.0
        self._N = rs.randn(17, 64) * 0.5
        self._P = rs.randn(64, 345) / 8.0
        self._W = rs.randn(17, 2) * 0.25
        self._u = rs.randn(17) / np.sqrt(17.0)
        self._h = np.zeros((batch_size, 64))
        self._z = np.zeros(batch_size)
        self._xy = np.zeros((batch_size, 2))
        self._v = np.zeros((batch_size, 2))
        self._t = np.zeros(batch_size, np.int64)
        self._noise = np.zeros((batch_size, 1000))
        self._obs = np.zeros((batch_size, 348), np.float32)
        self._rng = np.random.default_rng(seed)

    def _observe(self, idx) -> None:
        self._obs[idx, 0] = self._z[idx]
        self._obs[idx, 1:3] = self._v[idx]
        self._obs[idx, 3:] = self._h[idx] @ self._P

    def reset(self, indices=None, seeds=None) -> None:
        idx = np.arange(self.batch_size) if indices is None else np.asarray(indices)
        if seeds is None:
            seeds = self._rng.integers(0, 2**31 - 1, size=idx.size)
        for i, s in zip(idx.tolist(), seeds):
            rng = np.random.default_rng(int(s))
            self._h[i] = rng.normal(0.0, 0.1, 64)
            self._z[i] = 1.4 + rng.uniform(-0.01, 0.01)
            self._xy[i] = rng.uniform(-0.01, 0.01, 2)
            self._v[i] = 0.0
            self._noise[i] = rng.normal(0.0, 1.0, 1000)
            self._t[i] = 0
        self._observe(idx)

    def step(self, actions, indices=None):
        idx = np.arange(self.batch_size) if indices is None else np.asarray(indices)
        a = np.clip(np.asarray(actions, np.float64), -0.4, 0.4)
        self._h[idx] = np.tanh(self._h[idx] @ self._M + a @ self._N)
        self._v[idx] = a @ self._W
        self._xy[idx] += 0.015 * self._v[idx]
        self._z[idx] += 0.02 * self._noise[idx, self._t[idx]] - 0.0025 + 0.01 * (a @ self._u)
        self._t[idx] += 1
        self._observe(idx)
        z = self._z[idx]
        done = (z < 1.0) | (z > 2.0) | (self._t[idx] >= 1000)
        rew = 5.0 + 1.25 * self._v[idx, 0] - 0.1 * np.square(a).sum(axis=1)
        return rew.astype(np.float32), done

    def observe(self):
        return self._obs

    def final_state(self):
        return self._xy.astype(np.float32)

    def close(self) -> None:
        pass


@contextlib.contextmanager
def humanoid_engine():
    """The physics the MuJoCo phases run on: "mujoco" where gymnasium and
    mujoco import (the loader's own MujocoHostEnv), else "stand-in" (the
    loader's env resolution handed ``StandInHumanoid`` for the MuJoCo ids,
    while the context is open)."""
    from deep_neuroevolution_torch.envs import mujoco
    from deep_neuroevolution_torch.utils import config

    if mujoco.is_available():
        yield "mujoco"
        return
    real = config.resolve_env

    def resolve(env_id, **kwargs):
        if env_id.split("-")[0] in mujoco.MUJOCO_FAMILIES:
            return StandInHumanoid(**kwargs)
        return real(env_id, **kwargs)

    config.resolve_env = resolve
    try:
        yield "stand-in"
    finally:
        config.resolve_env = real


@contextlib.contextmanager
def record_round(n_members: int = 8, n_steps: int = 4):
    """The first host rollout's first ``n_steps`` steps while the context is
    open: the first ``n_members`` members' θ, the obs stats' mean and std,
    and each step's observations and actions (noise included), on the
    host."""
    from deep_neuroevolution_torch.algos import es

    real, rec = es.rollout_host, {"steps": []}

    def rollout(henv, act_fn, params, *a, **kw):
        if "thetas" in rec:
            return real(henv, act_fn, params, *a, **kw)
        thetas, ctx = params
        rec.update(thetas=thetas[:n_members].cpu(), mean=ctx.ob_mean.cpu(), std=ctx.ob_std.cpu())

        def act(p, obs):
            out = act_fn(p, obs)
            if len(rec["steps"]) < n_steps:
                rec["steps"].append((obs[:n_members].cpu(), out[:n_members].cpu()))
            return out

        act.prepare = act_fn.prepare
        return real(henv, act, params, *a, **kw)

    es.rollout_host = rollout
    try:
        yield rec
    finally:
        es.rollout_host = real


@contextlib.contextmanager
def record_increments():
    """The (stat, sums, count) of every obs-stat increment, and its result,
    on the host, while the context is open."""
    from deep_neuroevolution_torch.ops import obstat

    real, seen = obstat.increment, []

    def increment(stat, s, ssq, c):
        out = real(stat, s, ssq, c)
        host = lambda t: tuple(x.cpu() for x in t)  # noqa: E731
        seen.append((host(stat), s.cpu(), ssq.cpu(), float(c), host(out)))
        return out

    obstat.increment = increment
    try:
        yield seen
    finally:
        obstat.increment = real


def check_round_actions(model, rec: dict, device) -> dict:
    """The recorded round's actions against the port's CPU forward on the
    same θ, obs stats and observations: the card's noiseless forward within
    1e-5 + 1e-4·max|a| of the CPU's (float32 products in another order),
    and each recorded action within 6·ac_noise_std of the noiseless one (the
    action noise, N(0, 1)·ac_noise_std a slot)."""
    import torch

    from deep_neuroevolution_torch.models.mlp import MLPContext

    def forward(obs, dev):
        ctx = MLPContext(rec["mean"].to(dev), rec["std"].to(dev), 0.0)
        return model.make_batch_act()((rec["thetas"].to(dev), ctx), obs.to(dev)).cpu()

    errs, noise = [], []
    for obs, acts in rec["steps"]:
        card, cpu = forward(obs, device), forward(obs, torch.device("cpu"))
        errs.append(float((card - cpu).abs().max()))
        tol = 1e-5 + 1e-4 * float(cpu.abs().max())
        require(errs[-1] <= tol, f"humanoid: card forward disagrees with the CPU's: {errs[-1]} > {tol}")
        noise.append(float((acts - cpu).abs().max()))
        require(noise[-1] <= 6 * model.ac_noise_std + tol, f"humanoid: recorded actions {noise[-1]} off the forward")
    require(len(errs) > 0, "humanoid: no step recorded")
    return dict(steps=len(errs), members=int(rec["thetas"].shape[0]), card_vs_cpu_max_abs_err=max(errs),
                recorded_minus_noiseless_max=max(noise))


def run_humanoid_es(device, table, k2_l2_rate: float) -> dict:
    """Phase 28: one generation of configurations/humanoid.json as it
    stands through the loader (quota mode: rounds of 32 pairs on 64 slots
    until 1000 episodes and 100,000 steps; σ 0.02, calc_obstat_prob 0.01,
    30 eval episodes, the env's 1000-step cap) on phases 28-29's table: K2
    launches once and agrees with its plain version on the generation's
    offsets and weights (timed back-to-back and in a graph); a round's
    actions agree with the CPU forward; the obs stat after the update is the
    CPU's increment of the same sums. The seconds of rollout_host_vec's
    upload, forward and engine step (synced around each)."""
    import torch

    from deep_neuroevolution_torch.algos import rollout_host
    from deep_neuroevolution_torch.ops import obstat
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / HUMANOID).read_text())
    with humanoid_engine() as physics:
        tr = config.load_experiment(exp, device=device, noise_table=table)
    cfg = tr.config
    print(f"humanoid: {type(tr.env).__name__} ({physics}) slots={tr.env.batch_size} {type(tr.model).__name__} "
          f"D={tr.model.num_params} {json.dumps(dataclasses.asdict(cfg))}", flush=True)
    require(tr.quota_mode and tr.model.num_params == 159_505 and tr.env.obs_shape == (348,), "humanoid: not the file")
    zero_counters()
    rollout_host.vec_timings = timings = {}
    try:
        with record_k2() as seen, record_round() as rec, record_increments() as incs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = tr.train_step()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = read_counters()
    finally:
        rollout_host.vec_timings = None
        tr.close()
    episodes, steps = int(st.lengths.size), int(st.lengths.sum())
    npairs = tr._npairs_round()
    require(episodes >= cfg.episodes_per_batch and steps >= cfg.timesteps_per_batch, "humanoid: quotas not met")
    require(launches["noise_gradient"] == len(seen) == 1, f"humanoid: K2 launched {launches['noise_gradient']} times")
    idx, w = seen[0]
    require(idx.shape[0] == episodes // 2, "humanoid: K2 did not sum every pair")
    actions = check_round_actions(tr.model, rec, device)
    require(len(incs) == 1, f"humanoid: {len(incs)} obs-stat increments")
    stat, s, ssq, c, out = incs[0]
    cpu = obstat.increment(obstat.RunningStat(*stat), s, ssq, c)
    require(all(torch.equal(a, b) and torch.equal(a, t.cpu()) for a, b, t in zip(cpu, out, tr.ob_stat)),
            "humanoid: the obs stat is not the CPU's increment of the same sums")
    require(c > 0 and bool(np.isfinite(st.returns).all()) and bool(torch.isfinite(tr.theta).all()),
            "humanoid: no obs sampled, or not finite")
    total = sum(timings[k] for k in ("upload", "forward", "env_step"))
    out_row = dict(
        config=HUMANOID, physics=physics, engine=type(tr.env).__name__, slots=tr.env.batch_size,
        pairs_a_round=npairs, rounds=episodes // (2 * npairs), episodes=episodes, timesteps=steps,
        eval_episodes=int(st.eval_returns.size), seconds=seconds, env_steps_per_s=steps / seconds,
        length_mean=float(st.lengths.mean()), length_min=int(st.lengths.min()), length_max=int(st.lengths.max()),
        return_mean=float(st.returns.mean()), ob_count=c,
        vec_seconds={k: timings[k] for k in ("upload", "forward", "env_step")},
        vec_share={k: timings[k] / total for k in ("upload", "forward", "env_step")},
        vec_rollout_steps=timings["steps"], vec_slot_steps=timings["slot_steps"], actions=actions,
    )
    print("humanoid_es_generation " + json.dumps(out_row), flush=True)
    row = k2_case(device, table.noise, idx, w, tr.model.num_params, k2_l2_rate)
    return dict(stats=out_row, launches=launches, k2=row)


def run_humanoid_ns(device, table, k2_l2_rate: float, iterations: int = 2) -> dict:
    """Phase 29: two iterations of configurations/humanoid_nses.json through
    the loader (M = 3, k = 10, novelty_prob, the final mass centre as the
    BC) with its 1000 episodes in one round of 1000 slots, on phases
    28-29's table: K2 launches once an iteration and agrees with its plain
    version on each; the archive grows by one point an iteration. Seconds
    and env steps/s an iteration."""
    import torch

    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / HUMANOID_NS).read_text())
    with humanoid_engine() as physics:
        t0 = time.perf_counter()
        tr = config.load_experiment(exp, overrides={"env_kwargs": {"batch_size": NS_SLOTS}}, device=device,
                                    noise_table=table)
        setup = time.perf_counter() - t0
    try:
        require(tr._archive_size() == 3 and tr.config.bc_mode == "final" and tr._npairs_round() == NS_SLOTS // 2,
                "humanoid_nses: not the file's NS-ES")
        rows, errs = [], []
        zero_counters()
        with record_k2() as seen:
            for it in range(iterations):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = tr.train_step()
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
                steps = int(st.lengths.sum())
                rows.append(dict(iteration=it + 1, parent=st.parent, seconds=sec, episodes=int(st.lengths.size),
                                 timesteps=steps, env_steps_per_s=steps / sec, novelty_mean=float(st.novelty.mean()),
                                 archive=tr._archive_size()))
                require(tr._archive_size() == 4 + it, f"humanoid_nses: archive of {tr._archive_size()}")
            launches = read_counters()
        require(launches["noise_gradient"] == len(seen) == iterations, "humanoid_nses: K2 not once an iteration")
        for idx, w in seen:
            errs.append(check_k2(table.noise, idx, w, tr.model.num_params))
        require(all(bool(torch.isfinite(p.theta).all()) for p in tr.parents), "humanoid_nses: θ not finite")
    finally:
        tr.close()
    out = dict(config=HUMANOID_NS, physics=physics, engine=type(tr.env).__name__, slots=tr.env.batch_size,
               setup_seconds=setup, iterations=rows, k2_errs=errs)
    print("humanoid_nses_run " + json.dumps(out), flush=True)
    row = k2_case(device, table.noise, *seen[-1], tr.model.num_params, k2_l2_rate)
    return dict(stats=out, launches=launches, k2=row)


def run_native_extras() -> dict:
    """Phase 30: the engine's ALE backend built against the ALE API stub
    (``build_ale_stub``; a scripted counter game, not ALE) and the stress
    binary without TSAN (``build_stress(tsan=False)``), built side by side
    with g++. 256 stub slots stepped 100 times (finished slots reset) with
    the JAX package's tests/test_atari_path.py:383-418 checks and their
    emulator frames per second; EpisodicLife through lives(); the stress
    binary must print ``stress ok``."""
    from deep_neuroevolution_torch.native import build
    from deep_neuroevolution_torch.native.bridge import HostBatchEnv

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        stub_f, stress_f = pool.submit(build.build_ale_stub), pool.submit(build.build_stress, False)
        so, stress = stub_f.result(), stress_f.result()
    build_s = time.perf_counter() - t0
    B, steps, rs = 256, 100, np.random.RandomState(0)
    env = HostBatchEnv("ale", "stub.rom", batch_size=B, lib_path=str(so))
    try:
        require(env.num_actions == 4 and env.final_state_size == 128, "ale stub: actions or RAM size")
        require((env.frames_per_obs, env.height, env.width) == (2, 210, 160), "ale stub: frame shape")
        env.reset(rs.randint(1, 31, B).astype(np.int32), max_frames=10_000)
        total_rew, dones = 0.0, 0
        t0 = time.perf_counter()
        for _ in range(steps):
            r, d = env.step(rs.randint(0, 4, B).astype(np.int32))
            obs = env.observe()
            ram = env.final_state()
            total_rew += float(r.sum())
            dones += int(d.sum())
            if d.any():
                idx = np.nonzero(d)[0].astype(np.int32)
                env.reset(rs.randint(1, 31, idx.size).astype(np.int32), indices=idx, max_frames=10_000)
        sec = time.perf_counter() - t0
        require(obs.shape == (B, 2, 210, 160) and obs.any() and ram.shape == (B, 128), "ale stub: observations")
        require(total_rew > 0 and dones > 0, f"ale stub: reward {total_rew}, {dones} episodes ended")
    finally:
        env.close()
    env = HostBatchEnv("ale", "stub.rom", batch_size=1, num_threads=1, episodic_life=True, lib_path=str(so))
    try:
        env.reset(np.array([1], np.int32), max_frames=10_000)
        n = 0
        while n < 100 and not bool(env.step(np.zeros(1, np.int32))[1][0]):
            n += 1
        require(n < 100 and int(env.final_state()[0, 2]) == 2, "ale stub: EpisodicLife did not end on a life lost")
    finally:
        env.close()
    p = subprocess.run([str(stress)], capture_output=True, text=True, timeout=120)
    require(p.returncode == 0 and "stress ok" in p.stdout, f"stress binary: {p.returncode} {p.stderr[-500:]}")
    out = dict(build_seconds=build_s, stub_library=str(so.relative_to(ROOT)),
               stress_binary=str(stress.relative_to(ROOT)),
               slots=B, steps=steps, seconds=sec, frames_per_s=4 * B * steps / sec, episodes_ended=dones,
               reward=total_rew, stress=p.stdout.strip())
    print("native_extras " + json.dumps(out), flush=True)
    return out


# ----------------------------------------------------------- phase 31

INSPECTOR_TABLE = 25_000_000  # phase 31's table: the reference stream's first 25M floats (phase 13's is freed)
INSPECTOR_GENERATIONS = 2
INSPECTOR_MAZE_OVERRIDES = {}  # maze_es.json as it stands: 512 members, 400 steps
PCA_TOL = 1e-9  # card 'pca' against the CPU's, × max|CPU|, float64
FORCED_ROWS = 4  # slots of each recorded replay forward redone on the CPU: slot 0, the replayed episode, first


@contextlib.contextmanager
def recording_clouds():
    """What every ``vine.master_extract_cloud`` call is handed (iteration,
    then the BCs, returns, lengths, noise offsets and policy seeds, on the
    host), while the context is open."""
    from deep_neuroevolution_torch.utils import checkpoint, vine

    real, seen = vine.master_extract_cloud, []

    def recorded(base, iteration, *arrays):
        seen.append((int(iteration), [checkpoint.to_numpy(x).copy() for x in arrays]))
        return real(base, iteration, *arrays)

    vine.master_extract_cloud = recorded
    try:
        yield seen
    finally:
        vine.master_extract_cloud = real


@contextlib.contextmanager
def recording_theta_override():
    """The θ' that each ``replay_point`` hands ``viz.replay_snapshot``."""
    from deep_neuroevolution_torch.utils import viz

    real, seen = viz.replay_snapshot, []

    def recorded(*args, theta_override=None, **kw):
        seen.append(theta_override)
        return real(*args, theta_override=theta_override, **kw)

    viz.replay_snapshot = recorded
    try:
        yield seen
    finally:
        viz.replay_snapshot = real


def inspector_dumps(device, table, exp_file: str, overrides: dict, work: str) -> dict:
    """INSPECTOR_GENERATIONS ES generations of ``exp_file`` through the
    loader, ``vine_snapshot_dir`` set through the Python API (no loader or
    CLI reads it, in either package); what the trainer handed the dumps,
    and the kernels' launches."""
    from deep_neuroevolution_torch.utils import config

    exp = json.loads((ROOT / "configurations" / exp_file).read_text())
    tr = config.load_experiment(exp, overrides=overrides, device=device, noise_table=table)
    tr.config.vine_snapshot_dir = work
    with recording_clouds() as seen:
        zero_counters()
        _, seconds = synced_seconds(lambda: tr.train(INSPECTOR_GENERATIONS))
        launches = read_counters()
    out = dict(trainer=tr, seconds=seconds, launches=launches, seen=seen, k1_by_batch=by_batch_k1(),
               pairs=tr.config.population_size // 2, bc_dim=int(np.asarray(tr.last_stats.bc).shape[-1]))
    print(f"inspector dumps {exp_file}: " + json.dumps(dict(
        seconds=seconds, generations=INSPECTOR_GENERATIONS, pairs=out["pairs"], bc_dim=out["bc_dim"],
        launches=launches)), flush=True)
    require(launches["noise_gradient"] == INSPECTOR_GENERATIONS,
            f"{exp_file}: K2 launched {launches['noise_gradient']} times")
    dumped = [it for it, _ in seen]
    require(dumped == list(range(1, INSPECTOR_GENERATIONS + 1)), f"{exp_file}: dumps of generations {dumped}")
    return out


def check_dumps(path: str, run: dict) -> dict:
    """``load_data`` reads every generation back: 2 × pairs offspring rows,
    each column what the trainer held (float32 values through the dump's
    ten digits, integers exactly), and a parent row."""
    from deep_neuroevolution_torch.inspector import load_data

    pairs, bc_dim = run["pairs"], run["bc_dim"]
    require(load_data.list_generations(path) == list(range(1, INSPECTOR_GENERATIONS + 1)), "load_data: generations")
    for it, (bcs, rets, lens, idx, seeds) in run["seen"]:
        cloud = load_data.load_offspring(path, it, bc_dim)
        require(cloud.bc.shape == (2 * pairs, bc_dim), f"gen {it}: offspring rows {cloud.bc.shape}, want {2 * pairs}")
        seeds = seeds if seeds.ndim == 2 else np.stack([seeds, seeds], axis=1)
        want = dict(bc=bcs.reshape(2 * pairs, bc_dim), fitness=rets.reshape(-1), length=lens.reshape(-1),
                    noise_idx=np.repeat(idx, 2), policy_seed=seeds.reshape(-1), sign=np.tile([1.0, -1.0], pairs))
        for name, v in want.items():
            got = getattr(cloud, name)
            same = (np.array_equal(got, np.asarray(v, np.int64)) if name in ("noise_idx", "policy_seed")
                    else np.array_equal(np.float32(got), np.float32(v)))
            require(same, f"gen {it}: the dump's {name} column is not what the trainer held")
        parent = load_data.load_parent(path, it, bc_dim)
        require(parent.bc.shape == (bc_dim,) and math.isfinite(parent.fitness), f"gen {it}: parent row")
    return dict(rows_per_generation=2 * pairs, bc_dim=bc_dim)


def check_reduction(device, path: str, run: dict) -> dict:
    """``process_bc``: 'two_end', then 'pca' on the card against the same
    reduction on the CPU (within PCA_TOL·max|CPU|), each reduced directory
    read back by ``load_data``; 'tsne' where scikit-learn does not import
    must raise its ImportError."""
    import importlib.util

    from deep_neuroevolution_torch.inspector import load_data, process_bc, reduce

    pairs, bc_dim, gens = run["pairs"], run["bc_dim"], INSPECTOR_GENERATIONS
    out = {}
    two_end, out["two_end_seconds"] = synced_seconds(lambda: process_bc.process(1, gens, path, bc_dim, "two_end"))
    pca_dir, out["pca_seconds"] = synced_seconds(lambda: process_bc.process(1, gens, path, bc_dim, "pca",
                                                                             device=device))
    X, _, _, _, labels = reduce.assemble(1, gens, path, bc_dim=bc_dim)
    card, out["pca_card_seconds"] = synced_seconds(lambda: process_bc.reduced(X, labels, "pca", device))
    t0 = time.perf_counter()
    cpu = process_bc.reduced(X, labels, "pca", "cpu")
    out["pca_cpu_seconds"] = time.perf_counter() - t0
    out["pca_max_abs_err"] = float(np.abs(card - cpu).max())
    out["pca_tol"] = PCA_TOL * float(np.abs(cpu).max())
    out["pca_solver_sklearn_would_take"] = reduce.pca_solver(*X.shape)
    out["X"] = list(X.shape)
    require(out["pca_max_abs_err"] <= out["pca_tol"], f"pca card vs CPU {out['pca_max_abs_err']} > {out['pca_tol']}")
    for d in (two_end, pca_dir):
        require(load_data.list_generations(d) == list(range(1, gens + 1)), f"{d}: generations")
        cloud = load_data.load_offspring(d, gens, 2)
        require(cloud.bc.shape == (2 * pairs, 2) and np.isfinite(cloud.bc).all(), f"{d}: reduced rows {cloud.bc.shape}")
    if importlib.util.find_spec("sklearn") is None:
        try:
            reduce.reduce_dim(X[:50], labels=np.zeros(50), method="tsne")
            raise RuntimeError("'tsne' ran without scikit-learn")
        except ImportError as e:
            require("scikit-learn" in str(e) and "tsne" in str(e), f"tsne's ImportError: {e}")
            out["tsne"] = f"ImportError: {e}"
    else:
        out["tsne"] = "not checked: scikit-learn imports here"
    out["pca_dir"] = pca_dir
    return out


def point_rows(path: str, gen: int, bc_dim: int) -> dict:
    """Generation ``gen``'s parent point and its first +1 and −1 offspring
    rows, as the GUI hands them to ``replay_point``."""
    from deep_neuroevolution_torch.inspector import load_data
    from deep_neuroevolution_torch.inspector.interactive import Point

    parent = load_data.load_parent(path, gen, bc_dim)
    cloud = load_data.load_offspring(path, gen, bc_dim)
    row = np.concatenate([parent.bc, [parent.fitness, parent.length], parent.extras])
    points = {"parent": Point(gen, True, float(parent.bc[0]), float(parent.bc[1]), parent.fitness, row)}
    for name, sign in (("plus", 1.0), ("minus", -1.0)):
        i = int(np.flatnonzero(cloud.sign == sign)[0])
        row = np.concatenate([cloud.bc[i], [cloud.fitness[i], cloud.length[i], cloud.noise_idx[i],
                                            cloud.policy_seed[i], cloud.sign[i]]])
        points[name] = Point(gen, False, float(row[0]), float(row[1]), float(cloud.fitness[i]), row)
    return points


def replay_points(device, path: str, table, bc_dim: int, env_id, record_cls=None) -> dict:
    """``replay_point`` on the card for generation 2's parent point and a
    +1 and a −1 offspring row, each twice: θ' (the card's float32 product
    and sum) bit for bit the CPU's from the same file, table rows and row;
    the second replay bit for bit the first; with ``record_cls``, the
    model's forwards recorded (RECORD_CALLS at most) for teacher forcing.
    Prints each replayed return beside the fitness its row records."""
    import torch

    from deep_neuroevolution_torch.inspector import load_data, replay
    from deep_neuroevolution_torch.ops.noise import NoiseTable
    from deep_neuroevolution_torch.utils import checkpoint

    gen = INSPECTOR_GENERATIONS
    cpu_table = NoiseTable(table.noise.cpu())
    sigma = float(load_data.load_parent(path, gen, bc_dim).extras[-1])
    snap = str(Path(path) / "snapshots" / f"snapshot_gen_{gen:04d}" / f"snapshot_parent_{gen:04d}.h5")
    _, theta_cpu, _ = checkpoint.load_policy_snapshot(snap, device="cpu")
    out = {}
    for name, pt in point_rows(path, gen, bc_dim).items():
        calls, runs = [], []
        for rep in range(2):
            with recording_theta_override() as thetas, contextlib.ExitStack() as stack:
                if record_cls is not None and rep == 0:
                    stack.enter_context(recording_scores(record_cls, calls))
                zero_counters()
                np.random.seed(31)  # a parent point's replay draws its seed from numpy's global generator
                res, seconds = synced_seconds(lambda: replay.replay_point(
                    path, pt, noise_table=table, env_id=env_id, bc_dim=bc_dim, device=device))
                runs.append((res, seconds, read_counters(), by_batch_k1(), thetas[0]))
        (r1, s1, launches, k1_by_batch, th1), (r2, _, _, _, th2) = runs
        traj1, traj2 = (np.asarray(r["bc_trajectory"]) for r in (r1, r2))
        require(r1["returns"] == r2["returns"] and r1["lengths"] == r2["lengths"] and np.array_equal(traj1, traj2),
                f"replay of the {name} point: a second replay differs")
        if pt.parent:
            require(th1 is None and th2 is None, "a parent point's replay overrode θ")
            theta = theta_cpu
        else:
            idx, sign = int(pt.row[bc_dim + 2]), float(pt.row[bc_dim + 4])
            theta = replay.perturbed_theta(theta_cpu, cpu_table, idx, sign * sigma)
            require(torch.equal(th1, th2), f"replay of the {name} point: θ' differs between replays")
            same = torch.equal(th1.cpu().view(torch.int32), theta.view(torch.int32))
            require(th1.device.type == torch.device(device).type and same,
                    f"replay of the {name} point: θ' on the card is not the CPU's bit for bit")
        out[name] = dict(recorded_fitness=pt.fitness, replayed_return=r1["return_mean"], returns=r1["returns"],
                         lengths=r1["lengths"], seed=r1["seed"], seconds=s1, trajectory=list(traj1.shape),
                         k1=launches["population_linear"], k1_by_batch=k1_by_batch, repeat_equal=True,
                         theta_bit_equal_cpu=not pt.parent, calls=calls, theta=theta)
        print(f"inspector replay {name}: recorded fitness {pt.fitness} replayed return {r1['return_mean']} "
              f"(seed {r1['seed']}, {s1:.3f} s, K1 {launches['population_linear']})", flush=True)
    return out


def run_inspector(device, smi: str) -> dict:
    """Phase 31 (see the module docstring)."""
    import importlib.util

    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.ops.noise import NoiseTable
    from deep_neuroevolution_torch.utils import checkpoint, config

    steps = {}
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_vine_")
    try:
        table, steps["table_seconds"] = synced_seconds(lambda: NoiseTable.from_seed(count=INSPECTOR_TABLE,
                                                                                    device=device))
        print(f"inspector: a {INSPECTOR_TABLE}-float table built for the phase (phase 13's is freed)", flush=True)
        atari = str(Path(work.name) / "es_atari")
        run = inspector_dumps(device, table, "es_atari_config.json", SMOKE_OVERRIDES, atari)
        run["trainer"].close()
        steps["atari_dump_seconds"] = run["seconds"]
        require(run["launches"]["population_linear"] > 0, "the dumping ES generations never launched K1")
        loaded, steps["load_data_seconds"] = synced_seconds(lambda: check_dumps(atari, run))
        reduction = check_reduction(device, atari, run)
        replays = replay_points(device, atari, table, run["bc_dim"], "toy", VirtualBNDQN)
        model, _, payload = checkpoint.load_policy_snapshot(
            str(Path(atari) / "snapshots" / "snapshot_gen_0002" / "snapshot_parent_0002.h5"), device="cpu")
        for name, r in replays.items():
            require(r["k1"] > 0, f"the replay of the {name} point never launched K1")
            calls = r.pop("calls")
            err, tol, near = vbn_teacher_forced(model, r.pop("theta"), payload["ref_batch"], calls,
                                               f"inspector replay {name}, teacher-forced", rows=FORCED_ROWS)
            require(err <= tol, f"inspector replay {name} teacher-forced: {err} > {tol}")
            r.update(forwards_recorded=len(calls), teacher_forced_max_abs_err=err, teacher_forced_tol=tol,
                     near_ties=near)

        maze = str(Path(work.name) / "maze")
        mrun = inspector_dumps(device, table, "maze_es.json", INSPECTOR_MAZE_OVERRIDES, maze)
        steps["maze_dump_seconds"] = mrun["seconds"]
        mloaded = check_dumps(maze, mrun)
        mreplays = replay_points(device, maze, table, 2, None)
        thetas = torch.stack([r.pop("theta") for r in mreplays.values()]).to(device)
        for r in mreplays.values():
            r.pop("calls")
            require(r["trajectory"] == [400, 1, 2], f"maze replay trajectory {r['trajectory']}, want [400, 1, 2]")
        forced = maze_teacher_forced(config.resolve_env("maze"), mrun["trainer"].model, thetas, "inspector_maze")
        forced.pop("positions")
        del mrun["trainer"], run["trainer"]
        if importlib.util.find_spec("matplotlib") is None:
            print("inspector: the GUI (inspector/interactive.py) and inspector/plot.py were not run on this machine: "
                  "it has no matplotlib", flush=True)
            gui = "not run: no matplotlib"
        else:
            import matplotlib

            matplotlib.use("Agg", force=True)
            from deep_neuroevolution_torch.inspector import Inspector, plot_cloud_series

            plot_cloud_series(reduction["pca_dir"], out_png=str(Path(work.name) / "clouds.png"))
            insp = Inspector([reduction["pca_dir"]], interactive=False)
            insp.next()
            gui = f"run headless (Agg): visible {sorted(insp.visible)}"
    finally:
        work.cleanup()
    reduction.pop("pca_dir")
    out = dict(card=smi, table=INSPECTOR_TABLE, steps=steps, atari=dict(
        config="es_atari_config.json", cut=SMOKE_OVERRIDES, launches=run["launches"], k1_by_batch=run["k1_by_batch"],
        load_data=loaded, reduction=reduction, replays=replays),
        maze=dict(config="maze_es.json", launches=mrun["launches"], load_data=mloaded, replays=mreplays,
                  teacher_forced=forced), gui=gui)
    print("inspector " + json.dumps(out), flush=True)
    return out


# phase 32: the learning campaigns' scripts (scripts/*_torch.py) at a smoke cut
CAMPAIGN_MAZE = dict(es_gens=10, ns_iters=10, eval_every=5)
CAMPAIGN_PARITY = dict(seeds=1, gens=3)
CAMPAIGN_TOY = (("es", "es_toy_learn.json"), ("ga", "ga_toy_learn.json"))
CAMPAIGN_TOY_GENERATIONS = 2
CAMPAIGN_TOY_OVERRIDES = {"noise_size": 25_000_000}  # phase 4's table cut; nothing else of either file
CAMPAIGN_K1_CASES = ((32, 3872, 256, "float32"), (8, 3872, 256, "float32"))  # the toy ES's B, and phase 20's


def campaign_script(name: str):
    """A campaign script of scripts/, imported by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"campaign_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_keys(art: dict, jax_file: str, what: str) -> None:
    """The artifact's keys are the committed JAX artifact's plus ``device``,
    and each of its entries that is a dict there holds at least that
    dict's keys."""
    want = json.loads((ROOT / "results" / jax_file).read_text())
    require(set(art) == set(want) | {"device"}, f"{what}: keys {sorted(art)}, want {sorted(want)} + device")
    for k, v in want.items():
        if isinstance(v, dict):
            require(isinstance(art[k], dict) and set(v) <= set(art[k]), f"{what}: {k} lacks {set(v) - set(art[k])}")
    require(isinstance(art["device"], dict) and art["device"]["card"] and art["device"]["host_cpu"],
            f"{what}: no device entry")


def campaign_k2_rows(seen: list, table, dim: int, l2_rate: float, shapes: dict) -> dict:
    """K2 on the first recorded call of each pair count in ``shapes`` (name
    → pairs): checked against its plain version and timed (phase 3's
    ``k2_case``)."""
    rows = {}
    for name, pairs in shapes.items():
        idx, w = next((i, w) for i, w in seen if i.shape[0] == pairs)
        rows[name] = k2_case(table.device, table, idx, w, dim, l2_rate)
    return rows


def run_campaign_maze(device, work: Path, l2_rate: float) -> dict:
    """run_maze_comparison_torch.py's ``main`` at the smoke cut: ES and
    NS-ES at the JAX defaults (512 and 256 members, the 5M table) for
    CAMPAIGN_MAZE's generations. K2 once a generation; the distances
    finite and within the maze's diagonal; the artifact's keys the JAX
    one's; the ES parent's last eval teacher-forced against the CPU."""
    import torch

    from deep_neuroevolution_torch.ops.noise import NoiseTable

    mod = campaign_script("run_maze_comparison_torch")
    evals, real = [], mod.make_eval

    def recording(env, model):  # keeps each θ the script evaluates, and the eval's result
        ev = real(env, model)

        def eval_theta(theta):
            out = ev(theta)
            evals.append((env, model, theta.detach().clone(), out))
            return out
        return eval_theta

    mod.make_eval = recording
    c = CAMPAIGN_MAZE
    path = work / "maze_comparison_torch.json"
    argv = ["--es_gens", str(c["es_gens"]), "--ns_iters", str(c["ns_iters"]), "--eval_every", str(c["eval_every"]),
            "--out", str(path), "--device", str(device)]
    with record_k2() as seen:
        zero_counters()
        art, seconds = synced_seconds(lambda: mod.main(argv))
        launches = read_counters()
    print("campaign_maze launches " + json.dumps(launches), flush=True)
    require(launches["noise_gradient"] == len(seen) == c["es_gens"] + c["ns_iters"],
            f"maze comparison: K2 launched {launches['noise_gradient']} times")
    same_keys(json.loads(path.read_text()), "maze_comparison.json", "maze_comparison_torch.json")
    env = evals[0][0]
    segs = env.cfg["segs"]
    diag = math.hypot(np.ptp(segs[:, [0, 2]]), np.ptp(segs[:, [1, 3]]))
    es, ns = art["es"], art["nses"]
    dists = [es["best_offspring_dist"], es["final_parent_dist"], ns["best_offspring_dist"], *ns["final_parent_dists"]]
    require(all(math.isfinite(d) and 0 <= d <= diag for d in dists), f"maze comparison: distances {dists}")
    require(es["generations"] == c["es_gens"] and ns["iterations"] == c["ns_iters"] and len(ns["final_parent_dists"]) == 3,
            "maze comparison: generations, iterations or parents")
    n_es = c["es_gens"] // c["eval_every"]
    _, model, theta, (ret, bc) = evals[n_es - 1]  # the ES parent's last eval
    require(-ret == es["final_parent_dist"], "maze comparison: the ES parent's eval is not the artifact's")
    forced = maze_teacher_forced(env, model, theta[None], "campaign_maze_es_parent")
    last = forced.pop("positions")[-1, 0].numpy()
    require(float(np.abs(last - bc).max()) <= 1e-4, f"maze comparison: the eval's BC {bc} is not its episode's {last}")
    table = NoiseTable.from_seed(count=5_000_000, device=device)  # the script's table, built again
    k2 = campaign_k2_rows(seen, table.noise, model.num_params, l2_rate,
                          {"es": es["population"] // 2, "nses": ns["population"] // 2})
    del table
    torch.cuda.empty_cache()
    return dict(seconds=seconds, launches=launches, es_s_per_gen=es["s_per_gen"], ns_s_per_gen=ns["s_per_gen"],
                es_final_parent_dist=es["final_parent_dist"], ns_final_parent_dists=ns["final_parent_dists"],
                teacher_forced=forced, k2=k2)


def run_campaign_parity(device, work: Path, l2_rate: float) -> dict:
    """parity_study_torch.py's ``main`` at CAMPAIGN_PARITY's cut: both arms
    on the maze with MujocoMLP 32×32 (256 members), then the eval
    bit-identity check, which must hold. K2 once a generation."""
    import torch

    from deep_neuroevolution_torch.models import MujocoMLP
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    mod = campaign_script("parity_study_torch")
    c = CAMPAIGN_PARITY
    path = work / "parity_obstat_torch.json"
    argv = ["--seeds", str(c["seeds"]), "--gens", str(c["gens"]), "--out", str(path), "--device", str(device)]
    with record_k2() as seen:
        zero_counters()
        art, seconds = synced_seconds(lambda: mod.main(argv))
        launches = read_counters()
    print("campaign_parity launches " + json.dumps(launches), flush=True)
    arms_gens = len(mod.ARMS) * c["seeds"] * c["gens"]
    require(launches["noise_gradient"] == len(seen) == arms_gens + 2 * 3,
            f"parity study: K2 launched {launches['noise_gradient']} times")
    same_keys(json.loads(path.read_text()), "parity_obstat.json", "parity_obstat_torch.json")
    require(art["verdict"]["eval_count_bit_identical_theta"] is True,
            "parity study: θ differs between eval counts 0 and 8 on the card")
    for name, arm in art["arms"].items():
        require(all(math.isfinite(x) and x <= 0 for curve in arm["curves"] for x in curve), f"parity {name}: curves")
    dim = MujocoMLP(obs_dim=11, ac_dim=2, ac_low=(-1.0, -1.0), ac_high=(1.0, 1.0), hidden_dims=(32, 32)).num_params
    table = NoiseTable.from_seed(count=2_000_000, device=device)
    k2 = campaign_k2_rows(seen, table.noise, dim, l2_rate, {"mujoco_mlp": 128})
    del table
    torch.cuda.empty_cache()
    return dict(seconds=seconds, launches=launches, verdict=art["verdict"],
                s_per_gen={k: a["s_per_gen"] for k, a in art["arms"].items()}, k2=k2)


def run_campaign_toy(device, work: Path, l2_rate: float) -> dict:
    """es_toy_learn.json and ga_toy_learn.json through ``main train
    --log_dir`` for CAMPAIGN_TOY_GENERATIONS generations each (only the
    table cut), then assemble_toy_curves_torch.py on both logs. ES: K1 at
    B=32 and K2 once a generation (128 × 1,004,852); GA: K3 at B=32."""
    import torch

    from deep_neuroevolution_torch import main as cli
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    asm = campaign_script("assemble_toy_curves_torch")
    out = {}
    for algo, exp_file in CAMPAIGN_TOY:
        log_dir = work / f"toy_{algo}_campaign_torch"
        argv = ["train", "--exp_file", str(ROOT / "configurations" / exp_file), "--log_dir", str(log_dir),
                "--iterations", str(CAMPAIGN_TOY_GENERATIONS), "--overrides", json.dumps(CAMPAIGN_TOY_OVERRIDES),
                "--device", str(device)]
        print("main " + " ".join(argv), flush=True)
        with record_k2() as seen:
            zero_counters()
            tr, seconds = synced_seconds(lambda: cli.cmd_train(cli.build_parser().parse_args(argv)))
            launches = read_counters()
            k1_by_batch = by_batch_k1()
            k3_by_batch = dict(fk.large_dqn_fused_scores.launches_by_batch)
        print(f"campaign_toy_{algo} launches " + json.dumps({**launches, "population_linear.by_batch": k1_by_batch,
                                                            "large_dqn_fused_scores.by_batch": k3_by_batch}), flush=True)
        fn = asm.assemble_es if algo == "es" else asm.assemble_ga
        art = fn(out=str(work / f"toy_{algo}_curve_torch.json"), log_dir=str(log_dir), device=str(device))
        same_keys(art, f"toy_{algo}_curve_r05.json", f"toy_{algo}_curve_torch.json")
        require(art["generations"] == CAMPAIGN_TOY_GENERATIONS, f"toy {algo}: {art['generations']} generations")
        row = dict(seconds=seconds, launches=launches, s_per_gen=art["s_per_gen"],
                   final_mean_last5=art["final_mean_last5"])
        if algo == "es":
            require(launches["noise_gradient"] == len(seen) == CAMPAIGN_TOY_GENERATIONS,
                    f"toy ES: K2 launched {launches['noise_gradient']} times")
            require(k1_by_batch.get("B=32 bulk", 0) > 0, f"toy ES: K1 never launched at B=32 ({k1_by_batch})")
            row.update(k1_by_batch=k1_by_batch, k2=campaign_k2_rows(seen, tr.noise.noise, tr.model.num_params, l2_rate,
                                                                    {"vbn_dqn": 128}))
        else:
            require(k3_by_batch.get(32, 0) > 0, f"toy GA: K3 never launched at B=32 ({k3_by_batch})")
            row.update(k3_by_batch=k3_by_batch, k3=time_large_fused_by_batch(device, k3_by_batch))
        tr.close()
        del tr
        torch.cuda.empty_cache()
        out[algo] = row
    return out


def run_campaigns(device, l2_rate: float) -> dict:
    """Phase 32 (see the module docstring)."""
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_campaigns_")
    try:
        root = Path(work.name)
        out = dict(maze=run_campaign_maze(device, root, l2_rate), parity=run_campaign_parity(device, root, l2_rate),
                   toy=run_campaign_toy(device, root, l2_rate))
    finally:
        work.cleanup()
    out["k1"] = [check_population_linear(device, [case]) for case in CAMPAIGN_K1_CASES]
    return out


def main() -> int:
    import torch

    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.ops.noise import NoiseTable

    device = resolve_device("cuda")  # raises NoCudaDevice without a card
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # the policy files phase 25 replays
    # full float32 products everywhere (no TF32), for the checks below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device and build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)  # name, power limit
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
        t0 = time.perf_counter()
        build_all()
        print(f"build seconds: {time.perf_counter() - t0:.2f}", flush=True)

    with Phase("K1 population_linear"):
        k1 = check_population_linear(device)
    from deep_neuroevolution_torch.models import VirtualBNDQN

    dim = VirtualBNDQN(num_actions=4).num_params  # the ToyCatch VBN-DQN's θ size
    with Phase("K2 noise_gradient"):
        k2 = check_noise_gradient(device, dim)
    torch.cuda.empty_cache()

    with Phase("ES generation"):
        run = run_generation(device)
        check_generation(run)
    tr = run["trainer"]
    es_launches = run["launches"]
    from deep_neuroevolution_torch.utils import checkpoint

    toy_policy, maze_policy = (str(Path(work.name) / f) for f in ("es_toy_policy.pkl", "maze_policy.pkl"))
    checkpoint.save_policy_snapshot(toy_policy, tr.model, tr.theta, ref_batch=tr.ref_batch)
    timesteps = int(tr.last_stats.lengths.sum())
    gen_s = tr.last_stats.seconds  # train_step alone; set-up is the CLI's rest
    print(
        "generation " + json.dumps(dict(
            seconds=gen_s, setup_seconds=run["seconds"] - gen_s, episodes=int(tr.last_stats.lengths.size),
            timesteps=timesteps, frames_per_s=4 * timesteps / gen_s, steps_per_s=timesteps / gen_s,
            overrides=SMOKE_OVERRIDES,
        )),
        flush=True,
    )

    del run, tr
    torch.cuda.empty_cache()

    with Phase("K3 large_dqn_fused_scores"):
        k3 = check_large_fused(device)
    with Phase("K5 dqn_conv_chain_fused"):
        k5 = check_conv_chain(device)
    with Phase("K1 population_linear at the LargeDQN fc"):
        check_population_linear(device, [(128, 7744, 512, "float32")])
    torch.cuda.empty_cache()

    with Phase("GA generations"):
        ga = run_ga(device)
        check_ga(ga)
    ga_launches = ga["launches"]
    for r in ga["rows"]:
        sec, steps = r["TimeElapsedThisIter"], r["TimestepsThisIter"]
        print("ga_generation " + json.dumps(dict(
            iteration=r["Iteration"], seconds=sec, timesteps=steps, population_timesteps=r["PopulationTimesteps"],
            validation_timesteps=r["ValidationTimestepsThisIter"], frames_per_s=4 * steps / sec,
            reward_mean=r["PopulationEpRewMean"], elite_test_mean=r.get("TruncatedPopulationEliteTestRewMean"),
        )), flush=True)
    print("ga_run " + json.dumps(dict(seconds=ga["seconds"], peak_memory_gb=ga["peak_bytes"] / 1e9,
                                      overrides=GA_OVERRIDES)), flush=True)
    print("k3_launches_by_batch " + json.dumps(ga["k3_by_batch"]), flush=True)
    k3_by_batch = ga["k3_by_batch"]
    del ga
    torch.cuda.empty_cache()
    with Phase("K3 at the GA's batch sizes"):
        time_large_fused_by_batch(device, k3_by_batch)

    with Phase("RS generation"):
        rs = run_rs(device)
    st = rs["trainer"].state
    rs_launches = rs["launches"]
    k5_by_batch = rs["k5_by_batch"]
    print("rs_generation " + json.dumps(dict(
        seconds=rs["seconds"], timesteps=st.timesteps_so_far, frames_per_s=4 * st.timesteps_so_far / rs["seconds"],
        best_score=rs["trainer"].best_score, peak_memory_gb=rs["peak_bytes"] / 1e9, cut=RS_CUT,
    )), flush=True)
    print("k5_launches_by_batch " + json.dumps(k5_by_batch), flush=True)
    del rs
    torch.cuda.empty_cache()
    with Phase("K5 at the RS's batch sizes"):
        time_conv_chain_by_batch(device, k5_by_batch)

    with Phase("K4/K6 vbn_dqn_fused"):
        vbn = check_vbn_fused(device)
    route_launches, route_by_batch, route_times = {}, {}, {}
    pod_k3 = {}  # K3's launches in each rank of phase 27
    for impl in (*VBN_ROUTES, "split"):
        with Phase(f"ES generation, {impl}"):
            es_run = run_es_route(device, impl)
            check_es_route(es_run, impl)
        st = es_run["trainer"].last_stats
        steps = int(st.lengths.sum())
        print(f"es_{impl}_generation " + json.dumps(dict(
            seconds=st.seconds, setup_seconds=es_run["seconds"] - st.seconds, timesteps=steps,
            frames_per_s=4 * steps / st.seconds, eval_episodes=int(st.eval_returns.size),
            eval_return_mean=float(st.eval_returns.mean()), eval_seconds=es_run["eval_seconds"],
        )), flush=True)
        route_launches[impl] = es_run["launches"]
        route_by_batch[impl] = es_run["by_batch"]
        del es_run
        torch.cuda.empty_cache()
        if impl in VBN_ROUTES:
            with Phase(f"{VBN_ROUTES[impl][0]} at the ES generation's batch sizes"):
                route_times[impl] = time_vbn_by_batch(device, impl, route_by_batch[impl])

    with Phase("noise table") as table_phase:
        table = NoiseTable.from_seed(device=device)  # the reference's 250M floats, built once
    device_paths = {}
    for name in DEVICE_CONFIGS:
        with Phase(f"{name} ES generation"):
            run = run_device_es(device, name, table)
            check_device_es(run, name)
            if name == "maze":
                maze_teacher_forced(run["trainer"].env, run["trainer"].model, maze_members(run["trainer"]))
                checkpoint.save_policy_snapshot(maze_policy, run["trainer"].model, run["trainer"].theta)
            ab = graph_against_eager(run["trainer"], run["idx"])
        tr = run["trainer"]
        with Phase(f"K2 at the {name} generation's shape"):
            row = k2_case(device, table.noise, run["idx"], run["w"], tr.model.num_params, k2["l2_bytes_per_s"])
        st = tr.last_stats
        steps = int(st.lengths.sum())
        print(f"{name}_es_generation " + json.dumps(dict(
            config=DEVICE_CONFIGS[name], population=int(st.lengths.size), D=tr.model.num_params,
            seconds=st.seconds, timesteps=steps, eval_timesteps=int(st.eval_lengths.sum()),
            steps_per_s=steps / st.seconds, return_mean=float(st.returns.mean()),
            eval_return_mean=float(st.eval_returns.mean()), k2_ms=row["ms"], k2_graph_ms=row["graph_ms"],
            rollout_graph_seconds=ab["graph_seconds"], rollout_eager_seconds=ab["eager_seconds"],
        )), flush=True)
        device_paths[name] = k2_path_row(run["launches"], row)
        del run, tr

    with Phase("maze NS-ES iterations"):
        run = run_maze_ns(device, table)
    tr = run["trainer"]
    with Phase("K2 at the maze NS iterations' shape"):
        row = k2_case(device, table.noise, *run["seen"][-1], tr.model.num_params, k2["l2_bytes_per_s"])
    rows = run["rows"]
    print("maze_ns_run " + json.dumps(dict(
        config=NS_MAZE, iterations=len(rows), seconds=[r["seconds"] for r in rows],
        steps_per_s=[r["steps_per_s"] for r in rows], archive=tr._archive_size(), k2_errs=run["k2_errs"],
        k2_ms=row["ms"], k2_graph_ms=row["graph_ms"],
    )), flush=True)
    device_paths["maze_nses"] = k2_path_row(run["launches"], row)
    del run, tr
    ns_k1 = {}
    for name in NS_HOST:
        with Phase(f"{name} iterations"):
            run = run_host_ns(device, name, table)
        tr = run["trainer"]
        with Phase(f"K2 at the {name} iterations' shape"):
            row = k2_case(device, table.noise, *run["seen"][-1], tr.model.num_params, k2["l2_bytes_per_s"])
        rows = run["rows"]
        print(f"{name.split('.')[0]}_run " + json.dumps(dict(
            config=name, cut="Frostbite → ToyCatch", setup_seconds=run["setup"], iterations=len(rows),
            seconds=[r["seconds"] for r in rows], frames_per_s=[r["frames_per_s"] for r in rows],
            novelty_seconds=[r["novelty_seconds"] for r in rows], k2_errs=run["k2_errs"], k2_ms=row["ms"],
            k2_graph_ms=row["graph_ms"],
        )), flush=True)
        key = name.split(".")[0]
        device_paths[key] = k2_path_row(run["launches"], row)
        ns_k1[key] = dict(launches=run["launches"]["population_linear"], by_batch=run["by_batch"])
        tr.close()
        del run, tr
        torch.cuda.empty_cache()

    with Phase("frostbite_es.json generation (quota mode)"):
        run = run_quota_es(device, table)
    tr = run["trainer"]
    with Phase("K2 at the frostbite_es generation's shape"):
        row = k2_case(device, table.noise, run["idx"], run["w"], tr.model.num_params, k2["l2_bytes_per_s"])
    print("frostbite_es_run " + json.dumps(dict(
        **run["stats"], k2_err=run["k2_err"], k2_pairs=int(run["idx"].shape[0]), k2_ms=row["ms"],
        k2_graph_ms=row["graph_ms"], k2_bound_ms=row["bound_ms"], k2_l2_floor_ms=row["l2_floor_ms"],
    )), flush=True)
    device_paths["frostbite_es"] = k2_path_row(run["launches"], row)
    ns_k1["frostbite_es"] = dict(launches=run["launches"]["population_linear"], by_batch=run["by_batch"])
    del run, tr
    torch.cuda.empty_cache()

    with Phase("long runs: resume, mirrored pairs, maze quota"):
        long_runs = dict(
            resume_es=check_resume("es_atari_config.json", SMOKE_OVERRIDES, device),
            resume_maze_nses=check_resume("maze_nses.json", {"noise_size": 25_000_000}, device),
            mirrored_pairs=check_mirrored_pairs(device),
            maze_quota=check_maze_quota(device, table),
        )
    print("long_runs " + json.dumps(long_runs), flush=True)

    with Phase("frostbite_ga.json generations (GA, CPU-style chains)"):
        fga = run_frostbite_ga(device, table)
    ns_k1["frostbite_ga"] = dict(launches=fga["launches"]["population_linear"], by_batch=fga["by_batch"])
    with Phase("GA and RS on the device arm"):
        run_device_ga(device, table)
    del table
    torch.cuda.empty_cache()

    with Phase("ES generations on each obs mode, in turns"):
        obs_runs = run_obs_modes(device)
    for mode, (first, *_) in obs_runs.items():
        ns_k1[f"es_{mode}"] = dict(launches=first["k1"], by_batch=first["k1_by_batch"])
        device_paths[f"es_{mode}"] = dict(launches=first["k2"], B=first["pairs"], D=first["D"])
    print("es_obs_modes " + json.dumps(dict(
        phase4_gray=dict(seconds=gen_s, frames_per_s=4 * timesteps / gen_s),
        **{m: dict(seconds=[r["seconds"] for r in rs], frames_per_s=[r["frames_per_s"] for r in rs],
                   bytes_per_slot_step=rs[0]["bytes_per_slot_step"],
                   preprocess_card_vs_cpu=rs[0]["preprocess_card_vs_cpu"]) for m, rs in obs_runs.items()},
    )), flush=True)
    torch.cuda.empty_cache()

    with Phase("noise sources: VirtualNoise, the device-built table, ES and GA on them"):
        dim = VirtualBNDQN(num_actions=4).num_params
        noise_runs = dict(virtual_rows=check_virtual_rows(device, dim), from_key=check_from_key(device))
        torch.cuda.empty_cache()
        noise_runs["virtual_gradient"] = time_virtual_gradient(device, dim)
        noise_runs["es"] = run_es_noise_modes(device)
        noise_runs["maze_ga_virtual"] = run_maze_ga_virtual(device)
    noise_runs["from_key"]["host_from_seed_seconds"] = table_phase.seconds
    noise_runs["phase22_gray_seconds"] = [r["seconds"] for r in obs_runs["gray"]]
    print("noise_sources " + json.dumps(noise_runs), flush=True)
    torch.cuda.empty_cache()

    with Phase("model variants: other nonlinearities, BNDQN, the chunked prepare"):
        variants = run_model_variants(device)
    torch.cuda.empty_cache()

    with Phase("replay: a policy file, a LargeDQN chain, the maze"):
        replays = dict(toy=replay_toy_policy(device, toy_policy), large_chain=replay_large_chain(device),
                       maze=replay_maze_policy(device, maze_policy, work.name))
    work.cleanup()

    from deep_neuroevolution_torch.ops.noise import NoiseTable

    with Phase("a world of one rank on NCCL: the device pods against the single trainers"):
        table = NoiseTable.from_seed(device=device)  # phase 13's table again
        pod_one = run_pod_world_of_one(device, table)
        del table
        torch.cuda.empty_cache()
    print("pod_world_of_one " + json.dumps(pod_one), flush=True)
    with Phase("two ranks sharing the card over gloo: device and host pods against their emulation"):
        pod_two = run_pod_two_ranks(device)
    print("pod_two_ranks " + json.dumps(pod_two), flush=True)

    with Phase("the vector host engine: one humanoid.json generation"):
        htable = NoiseTable.from_seed(count=HUMANOID_TABLE, device=device)
        humanoid = run_humanoid_es(device, htable, k2["l2_bytes_per_s"])
        print(f"humanoid card: {smi}", flush=True)
    with Phase("the vector host engine: two humanoid_nses.json iterations"):
        humanoid_ns = run_humanoid_ns(device, htable, k2["l2_bytes_per_s"])
    del htable
    torch.cuda.empty_cache()
    with Phase("native extras: the ALE-stub engine and the stress binary"):
        run_native_extras()
    torch.cuda.empty_cache()
    with Phase("the inspector on the card: dumps, load_data, process_bc, point replays"):
        insp = run_inspector(device, smi)
    torch.cuda.empty_cache()
    with Phase("the learning campaigns at a smoke cut: maze ES against NS-ES, the parity study, the toy curves"):
        camp = run_campaigns(device, k2["l2_bytes_per_s"])
    print("campaigns " + json.dumps(dict(
        card=smi, maze=dict(seconds=camp["maze"]["seconds"], es_s_per_gen=camp["maze"]["es_s_per_gen"],
                            ns_s_per_gen=camp["maze"]["ns_s_per_gen"], k2=camp["maze"]["launches"]["noise_gradient"],
                            es_final_parent_dist=camp["maze"]["es_final_parent_dist"],
                            ns_final_parent_dists=camp["maze"]["ns_final_parent_dists"]),
        parity=dict(seconds=camp["parity"]["seconds"], s_per_gen=camp["parity"]["s_per_gen"],
                    verdict=camp["parity"]["verdict"], k2=camp["parity"]["launches"]["noise_gradient"]),
        toy={a: dict(seconds=r["seconds"], s_per_gen=r["s_per_gen"], k1=r["launches"]["population_linear"],
                     k2=r["launches"]["noise_gradient"], k3=r["launches"]["large_dqn_fused_scores"])
             for a, r in camp["toy"].items()},
    )), flush=True)
    for key, run in (("humanoid_es", humanoid), ("humanoid_nses", humanoid_ns)):
        device_paths[key] = dict(k2_path_row(run["launches"], run["k2"]), physics=run["stats"]["physics"])
    device_paths["pod1_maze_es"] = dict(launches=pod_one["es"]["launches"]["noise_gradient"], B=256, D=498)
    for case, row in pod_two["cases"].items():
        for r in (0, 1):
            first = row[f"rank{r}"]["launches"][0]
            for kname, paths in (("population_linear", ns_k1), ("noise_gradient", device_paths),
                                 ("large_dqn_fused_scores", None)):
                if first[kname]:
                    rec = dict(launches=first[kname])
                    if paths is None:
                        pod_k3[f"pod2_{case}_rank{r}"] = rec
                    else:
                        paths[f"pod2_{case}_rank{r}"] = rec
    es_virtual, es_device = (noise_runs["es"][m]["generations"][0] for m in NOISE_MODES)
    ns_k1["es_virtual"] = dict(launches=es_virtual["k1"], by_batch=noise_runs["es"]["virtual"]["k1_by_batch"])
    ns_k1["model_variants"] = dict(launches=sum(r["k1"] for r in variants["rows"]),
                                   by_batch={r["model"]: r["k1"] for r in variants["rows"]})
    ns_k1["replay_toy"] = dict(launches=replays["toy"]["k1"], by_batch=replays["toy"]["k1_by_batch"])
    ns_k1["inspector_es_atari"] = dict(launches=insp["atari"]["launches"]["population_linear"],
                                       by_batch=insp["atari"]["k1_by_batch"])
    for name, r in insp["atari"]["replays"].items():
        ns_k1[f"inspector_replay_{name}"] = dict(launches=r["k1"], by_batch=r["k1_by_batch"])
    pairs = SMOKE_OVERRIDES["population_size"] // 2
    device_paths["inspector_es_atari"] = dict(launches=insp["atari"]["launches"]["noise_gradient"], B=pairs, D=dim)
    device_paths["inspector_maze_es"] = dict(launches=insp["maze"]["launches"]["noise_gradient"], B=256, D=498)
    device_paths["es_virtual"] = dict(launches=es_virtual["k2"], B=pairs, D=dim)
    toy_es, toy_ga = camp["toy"]["es"], camp["toy"]["ga"]
    ns_k1["campaign_toy_es"] = dict(launches=toy_es["launches"]["population_linear"], by_batch=toy_es["k1_by_batch"])
    for name, run in (("maze", camp["maze"]), ("parity", camp["parity"]), ("toy_es", toy_es)):
        device_paths[f"campaign_{name}"] = dict(launches=run["launches"]["noise_gradient"],
                                                shapes={k: k2_path_row(run["launches"], r) for k, r in run["k2"].items()})
    pod_k3["campaign_toy_ga"] = dict(
        launches=toy_ga["launches"]["large_dqn_fused_scores"], by_batch={str(b): n for b, n in toy_ga["k3_by_batch"].items()},
        **{f"{k}_by_batch": {str(r["B"]): r[k] for r in toy_ga["k3"]["rows"]} for k in ("graph_ms", "bound_ms", "max_abs_err")})
    device_paths["es_device"] = dict(launches=es_device["k2"], B=pairs, D=dim,
                                     max_abs_err=noise_runs["es"]["device"]["k2_max_abs_err"])

    def entry(name, source, replaces, launches, k, **extra):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"], **extra,
        }

    # K3's and K5's numbers at the shape their path gives them: B=128, one
    # pipeline group of 256 slots, ToyCatch's 4 actions, float32 for K5
    k3_row = next(r for r in k3 if (r["B"], r["num_actions"]) == (128, 4))
    k5_row = k5[0]
    k4_row, k6_row = (next(r for r in vbn if (r["name"], r["B"], r["num_actions"]) == (VBN_ROUTES[i][0], 128, 4))
                      for i in ("fused1", "fused"))

    def vbn_extra(impl, row):
        """K4's or K6's graph time at B=128, its launches by batch size in
        the route's generation and its graph time at each."""
        return dict(graph_ms=row["graph_ms"], split_ms=row["split_ms"],
                    launches_by_batch={str(b): n for b, n in route_by_batch[impl].items()},
                    graph_ms_by_batch={str(r["B"]): r["graph_ms"] for r in route_times[impl]["rows"]})

    kernels = [
        entry("population_linear", "deep_neuroevolution_torch/csrc/population_linear.cu",
              "deep_neuroevolution_tpu/ops/pallas_forward.py:59", es_launches, k1, variant=k1["variant"],
              other_paths=ns_k1,
              other_shapes=[{k: r[k] for k in ("B", "K", "N", "dtype", "variant", "ms", "graph_ms", "bound_ms",
                                               "bound_by", "plain_ms", "library_ms", "library_graph_ms", "max_abs_err")}
                            for r in camp["k1"]]),
        entry("noise_gradient", "deep_neuroevolution_torch/csrc/noise_gradient.cu",
              "deep_neuroevolution_tpu/ops/pallas_kernels.py:120", es_launches, k2, B=k2["B"],
              table=k2["table"], graph_ms=k2["graph_ms"], l2_floor_ms=k2["l2_floor_ms"],
              library_note=k2["library_note"],
              other_shapes=[{k: r[k] for k in ("B", "table", "ms", "graph_ms", "bound_ms", "l2_floor_ms",
                                               "plain_ms", "library_ms", "max_abs_err")} for r in k2["other_shapes"]],
              other_paths=device_paths),
        entry("large_dqn_fused_scores", "deep_neuroevolution_torch/csrc/large_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:298", ga_launches, k3_row,
              graph_ms=k3_row["graph_ms"], split_ms=k3_row["split_ms"],
              other_paths={"replay_large_chain": dict(
                  launches=replays["large_chain"]["k3"], by_batch=replays["large_chain"]["k3_by_batch"],
                  graph_ms_by_batch=replays["large_chain"]["k3_graph_ms_by_batch"],
                  bound_ms_by_batch=replays["large_chain"]["k3_bound_ms_by_batch"],
                  max_abs_err_by_batch=replays["large_chain"]["k3_plain_max_abs_err_by_batch"],
                  teacher_forced_max_abs_err=replays["large_chain"]["teacher_forced_max_abs_err"]), **pod_k3}),
        entry("vbn_dqn_fused1_scores", "deep_neuroevolution_torch/csrc/vbn_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:147", route_launches["fused1"], k4_row,
              **vbn_extra("fused1", k4_row)),
        entry("dqn_conv_chain_fused", "deep_neuroevolution_torch/csrc/dqn_conv_chain.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:422", rs_launches, k5_row,
              graph_ms=k5_row["graph_ms"], einsum_ms=k5_row["einsum_ms"],
              launches_by_batch={str(b): n for b, n in k5_by_batch.items()}),
        entry("vbn_dqn_fused_scores", "deep_neuroevolution_torch/csrc/vbn_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:471", route_launches["fused"], k6_row,
              **vbn_extra("fused", k6_row)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-rank"]:  # a rank of phase 27
        pod_child(int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
        sys.exit(0)
    sys.exit(main())
