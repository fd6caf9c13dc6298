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
   offsets. Nothing is cut but the game.

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
            conv_ops = 2 * B * (441 * 256 * 32 + 121 * 512 * 64 + 121 * 576 * 64)  # bf16 products
            f32_ops = 2 * B * (121 * 64 * 512 + 512 * 64)  # the fc (f32 x3) and the out layer
            bound_ms, bound_by = bound(nbytes(*ops.values(), y), {"bfloat16": conv_ops, "float32": f32_ops})
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
    """K3 at each batch size the GA launched it with, on first-generation
    genomes of the phase's 4-action LargeDQN, checked and timed."""
    import torch

    from deep_neuroevolution_torch.models.core import extract_patches
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(7)
    model = LargeDQN(num_actions=4, forward_impl="fused")

    def make_call(B):
        parts, _ = model.prepare_batch_params((random_genomes(model, B, gen, device), None))
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
        ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
        return lambda: fk.large_dqn_fused_scores(ops), lambda: fk.large_dqn_fused_scores_plain(ops)

    # as phase 5: 1e-3·max|score| over the 4 actions (the other lanes carry the -1e9 bias)
    return time_by_batch("large_dqn_fused_scores", by_batch, make_call, 1e-3, lanes=4)


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

    def recorded(table_, idxs, weights, dim):
        seen.append((idxs.clone(), weights.clone()))
        return real(table_, idxs, weights, dim)

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


def maze_teacher_forced(tr, members: int = 8) -> dict:
    """A whole 400-step maze episode of ``members`` perturbed members of
    the trainer's θ recorded on the card; then each recorded state goes
    through the CPU's observe, forward and step (fed the card's actions),
    and that one step must match the card's: observations and actions
    within 1e-5, the state and reward within 1e-4 (a few float32 ulps of a
    coordinate near 200: sin, cos and division round otherwise on the
    card), done and the step counter exactly."""
    import torch

    env, model, D = tr.env, tr.model, tr.model.num_params
    idx = torch.from_numpy(np.linspace(0, tr.noise.size - D, members).astype(np.int32)).to(tr.device)
    thetas = tr.theta[None] + tr.config.noise_stdev * tr.noise.get_batch(idx, D)
    parts = {k: v.contiguous() for k, v in model.unflatten(thetas).items()}
    state, rec = env.reset(members, None, tr.device), []
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
        require(torch.equal(d_c, d) and torch.equal(ns_c.t, ns.t), "maze: done or the step counter differs")
        moved += int(((ns.x != s.x) | (ns.y != s.y)).sum())
        undone += int(((ns.x == s.x) & (ns.y == s.y) & (ns.speed != 0)).sum())  # a wall in the way
    print("maze_teacher_forced " + json.dumps(dict(members=members, steps=len(rec), moves=moved,
                                                   moves_undone=undone, **errs)), flush=True)
    for k, tol in (("obs", 1e-5), ("action", 1e-5), ("state", 1e-4), ("reward", 1e-4)):
        require(errs[k] <= tol, f"maze: card vs CPU {k} max abs err {errs[k]} > {tol}")
    require(moved > 0, "maze: no member moved")
    return errs

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


def main() -> int:
    import torch

    from deep_neuroevolution_torch import resolve_device

    device = resolve_device("cuda")  # raises NoCudaDevice without a card
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

    from deep_neuroevolution_torch.ops.noise import NoiseTable

    with Phase("noise table"):
        table = NoiseTable.from_seed(device=device)  # the reference's 250M floats, built once
    device_paths = {}
    for name in DEVICE_CONFIGS:
        with Phase(f"{name} ES generation"):
            run = run_device_es(device, name, table)
            check_device_es(run, name)
            if name == "maze":
                maze_teacher_forced(run["trainer"])
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
    del table
    torch.cuda.empty_cache()

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
              other_paths=ns_k1),
        entry("noise_gradient", "deep_neuroevolution_torch/csrc/noise_gradient.cu",
              "deep_neuroevolution_tpu/ops/pallas_kernels.py:120", es_launches, k2, B=k2["B"],
              table=k2["table"], graph_ms=k2["graph_ms"], l2_floor_ms=k2["l2_floor_ms"],
              library_note=k2["library_note"],
              other_shapes=[{k: r[k] for k in ("B", "table", "ms", "graph_ms", "bound_ms", "l2_floor_ms",
                                               "plain_ms", "library_ms", "max_abs_err")} for r in k2["other_shapes"]],
              other_paths=device_paths),
        entry("large_dqn_fused_scores", "deep_neuroevolution_torch/csrc/large_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:298", ga_launches, k3_row,
              graph_ms=k3_row["graph_ms"], split_ms=k3_row["split_ms"]),
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
    sys.exit(main())
