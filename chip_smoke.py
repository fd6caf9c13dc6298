#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deep_neuroevolution_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA device, nvcc and
g++. Phases, each printing its name when it starts and its seconds when it
ends:

1. device and build: the card's name and power limit; nvcc builds the
   kernels and g++ the host engine, side by side;
2. kernel K1 (population_linear) against its plain PyTorch version, float32
   and bfloat16, at the population fc's shapes (B=256, 128 and the eval
   episodes' 4), each on the bulk variant, beside one ``torch.bmm``;
3. kernel K2 (noise_gradient) against its plain version at the ES
   gradient's shape, with unaligned offsets and one slice that ends at the
   table's last element;
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
   LargeDQN geometries, float32 and bfloat16, beside the batched-product
   conv chain's time; and K1 at the LargeDQN's fc shape;
7. two GA generations of configurations/ga_atari_config.json (LargeDQN)
   through ``main train`` on the ToyCatch engine at full width, the
   population, cutoff and noise table cut to smoke size: K3's counter must
   move, every chain of generation 2 be of length 2 (but the elite carried
   over), and a small forward on the card match the CPU's plain K3; then
   K3 is timed (in a CUDA graph) at each batch size the two generations
   launched it with, for its launches × time by batch size;
8. one random-search generation of configurations/rs_atari_config.json
   (SmallDQN) through the Python API with ``conv_impl='fused'``: the K5
   and K1 counters must move;
9. kernels K4 (vbn_dqn_fused1_scores) and K6 (vbn_dqn_fused_scores), the
   VBN-DQN's whole-net forwards, against their plain versions at B=1, 8,
   128 and 256, 4 and 18 actions, beside the split route's time (convs, K1
   and the out layer) in float32 and bfloat16;
10. one ES generation of configurations/es_atari_config.json at phase 4's
   cut through the Python API with ``forward_impl='fused1'``: K4's counter
   must move, the 8 eval episodes run, and a small forward on the card (K4)
   must agree with the CPU's plain K4;
11. the same with ``forward_impl='fused'`` and K6;
12. the same with ``forward_impl='split'`` (K1), so that the three routes'
   generations are timed alike, each after a warm-up of the process.
   Each of phases 10-12 also times its trainer's eval episodes alone.

Every failure raises and the script exits non-zero without its last line.
On success the line before the last is a JSON object with each kernel's
numbers, and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
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
# phase's per-group shape) and at B=256 for both geometries and types
K3_BATCHES = (128, 256)
K5_BATCHES = (128, 256)
# phase 8's cut of rs_atari_config.json (population 1000, cutoff 5000)
RS_CUT = {"population_size": 256, "episode_cutoff_mode": 200, "noise_size": 25_000_000, "batch_size": 256}
# K4 and K6 at B=8 (the eval episodes), 128 (one of an ES round's two
# pipeline groups) and 256, and at B=1
VBN_BATCHES = (1, 8, 128, 256)
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
# B=4 is an eval-episode group's (8 slots, two groups)
K1_CASES = ((256, 3872, 256, "float32"), (256, 3872, 256, "bfloat16"), (128, 3872, 256, "float32"),
            (4, 3872, 256, "float32"))


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


def check_noise_gradient(device, dim: int) -> dict:
    import torch

    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain

    gen = torch.Generator(device=device).manual_seed(2)
    count = 250_000_000  # the reference's table length, drawn on the card
    table = torch.randn(count, generator=gen, device=device)
    out = {}
    # B=2500 pairs is es_atari_config.json's population; B=256 is phase 4's
    for B in (2500, 256):
        idx = torch.randint(0, count - dim + 1, (B,), generator=gen, device=device, dtype=torch.int32)
        idx[0] = count - dim  # this slice ends at table[count - 1]
        idx[1] = 1  # unaligned
        w = torch.randn(B, generator=gen, device=device)
        g = noise_gradient(table, idx, w, dim)
        ref = noise_gradient_plain(table, idx, w, dim)
        torch.cuda.synchronize()
        err = float((g - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())  # float32 sums in another order
        require(bool(torch.isfinite(g).all()), "noise_gradient returned non-finite values")
        require(err <= tol, f"noise_gradient B={B}: max abs err {err} > {tol}")
        ms = cuda_ms(lambda: noise_gradient(table, idx, w, dim), 5)
        plain_ms = cuda_ms(lambda: noise_gradient_plain(table, idx, w, dim), 3, warmup=1)
        # least bytes: the table elements the slices cover, read once, plus
        # the offsets, the weights and g
        nbytes = union_bytes(idx.cpu(), dim) + B * 8 + dim * 4
        bound_ms, bound_by = bound(nbytes, 2 * B * dim, "float32")
        row = dict(B=B, D=dim, table=count, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                   streamed_slices_ms=B * dim * 4 / PEAK_BYTES_PER_S * 1e3)
        print("noise_gradient " + json.dumps(row), flush=True)
        out[B] = row
    del table
    return out[2500]


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
    kernel_counters()["large_dqn_fused_scores"].launches_by_batch.clear()


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


def check_conv_chain(device) -> list:
    """K5 against its plain version. float32: within 1e-5·max|x| (sums in
    another order). bfloat16: within 1e-3·max|x|, as K3 (the bf16 roundings
    of the intermediates are kept; dropping them moves x by 2e-3·max or
    more)."""
    import torch

    from deep_neuroevolution_torch.models.dqn import LargeDQN, SmallDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(4)
    rows = []
    cases = [(SmallDQN, "float32", K5_BATCHES[0])] + [
        (c, d, K5_BATCHES[1]) for c in (SmallDQN, LargeDQN) for d in ("float32", "bfloat16")
    ]
    for cls, dt, B in cases:
        kw = {"forward_impl": "split"} if cls is LargeDQN else {}
        fused, einsum = (cls(num_actions=4, compute_dtype=dt, conv_impl=impl, **kw) for impl in ("fused", "einsum"))
        th = random_genomes(fused, B, gen, device)
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
        parts, _ = fused.prepare_batch_params((th, None))
        args = fused.conv_chain_args(parts, obs)
        y = fk.dqn_conv_chain_fused(*args)
        ref = fk.dqn_conv_chain_plain(*args)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = (1e-5 if dt == "float32" else 1e-3) * float(ref.abs().max())
        require(bool(torch.isfinite(y).all()), "dqn_conv_chain_fused returned non-finite values")
        require(err <= tol, f"dqn_conv_chain_fused {cls.__name__} {dt} B={B}: max abs err {err} > {tol}")
        ms = cuda_ms(lambda: fk.dqn_conv_chain_fused(*args), 20)
        plain_ms = cuda_ms(lambda: fk.dqn_conv_chain_plain(*args), 5)
        einsum_ms = cuda_ms(lambda: einsum.conv_acts(parts, obs), 10)
        (_, c1, _, _), (_, c2, _, _) = cls.LAYERS[:2]
        c3 = cls.LAYERS[2][1] if len(cls.LAYERS) > 2 else 0
        ops = 2 * B * (441 * 256 * c1 + 121 * 16 * c1 * c2 + 121 * 9 * c2 * c3)
        bound_ms, bound_by = bound(nbytes(*args, y), ops, dt)
        row = dict(model=cls.__name__, dtype=dt, B=B, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   einsum_ms=einsum_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        print("dqn_conv_chain_fused " + json.dumps(row), flush=True)
        rows.append(row)
        del th, parts, args, y, ref
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


def time_large_fused_by_batch(device, by_batch: dict) -> dict:
    """K3's device time (in a CUDA graph, after a warm-up) at each batch
    size the GA launched it with, on first-generation genomes of the
    phase's 4-action LargeDQN; prints launches × time by batch size and the
    share of K3's time in batches below 128 (the ladder's buckets)."""
    import torch

    from deep_neuroevolution_torch.models.core import extract_patches
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    gen = torch.Generator(device=device).manual_seed(7)
    model = LargeDQN(num_actions=4, forward_impl="fused")
    rows = []
    for B, launches in by_batch.items():
        parts, _ = model.prepare_batch_params((random_genomes(model, B, gen, device), None))
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
        ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
        warm(lambda: fk.large_dqn_fused_scores(ops), 0.3)
        ms = graph_ms(lambda: fk.large_dqn_fused_scores(ops))
        rows.append(dict(B=B, launches=launches, graph_ms=ms, launches_x_ms=launches * ms))
        print("large_dqn_fused_scores_by_batch " + json.dumps(rows[-1]), flush=True)
        del parts, obs, ops
        torch.cuda.empty_cache()
    total = sum(r["launches_x_ms"] for r in rows)
    small = sum(r["launches_x_ms"] for r in rows if r["B"] < 128)
    summary = dict(launches=sum(by_batch.values()), total_ms=total, below_128_ms=small,
                   below_128_share=small / total if total else 0.0)
    print("large_dqn_fused_scores_by_batch_total " + json.dumps(summary), flush=True)
    return summary


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
    finally:
        env.close()
    print("launches " + json.dumps(launches), flush=True)
    for name in ("dqn_conv_chain_fused", "population_linear"):
        require(launches[name] > 0, f"random search never launched {name}")
    require(tr.state.it == 1 and tr.best_seeds is not None and len(tr.best_seeds) == 1
            and math.isfinite(tr.best_score), "random search kept no best genome")
    return dict(trainer=tr, seconds=seconds, launches=launches, peak_bytes=torch.cuda.max_memory_allocated(device))


def vbn_members(model, B: int, gen, device):
    """B members θ + 0.02·ε around a fresh init θ (the ES's perturbed
    population), ε ~ N(0, 1) drawn on the card."""
    import torch

    base = model.init_theta(torch.Generator().manual_seed(B), device)
    return base[None] + 0.02 * torch.randn((B, model.num_params), generator=gen, device=device)


def check_vbn_fused(device) -> list:
    """K4 and K6 against their plain versions on the same inputs, with the
    stats of a reference batch of random frames. Tolerance 1e-3·max|score|:
    both keep the bf16 roundings (x1; x2 in K6) and sum in f32, in other
    orders, so a sum near a rounding boundary can round one ulp the other
    way; dropping or swapping a rounding point moves the scores by 3.7e-3·max
    or more (tests/test_torch_vbn_fused.py TestCardTolerance)."""
    import torch

    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.models.core import extract_patches
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
            patches1 = extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256)
            for impl, (name, plain_name) in VBN_ROUTES.items():
                fn, plain = getattr(fk, name), getattr(fk, plain_name)
                parts, _ = VirtualBNDQN(num_actions=na, forward_impl=impl).prepare_batch_params((th, stats))
                ops = dict(parts["__fused__"], patches1=patches1)
                y = fn(ops)
                ref = plain(ops)
                torch.cuda.synchronize()
                err = float((y[:, :na] - ref[:, :na]).abs().max())
                tol = 1e-3 * float(ref[:, :na].abs().max())
                require(bool(torch.isfinite(y).all()), f"{name} returned non-finite values")
                require(err <= tol, f"{name} B={B} A={na}: max abs err {err} > {tol}")
                require(bool((y[:, na:] < -1e8).all()), f"{name}: a padded action lane lost its -1e9 bias")
                clear = check_top_actions(y[:, :na], ref[:, :na], tol, f"{name} B={B} A={na}")
                ms = cuda_ms(lambda: fn(ops), 20)
                plain_ms = cuda_ms(lambda: plain(ops), 3, warmup=1)
                conv_ops = 2 * B * (441 * 256 * 16 + 121 * 256 * 32)  # bf16 products
                fc_ops = 2 * B * 121 * 32 * 256  # x2 f32 (K4) or bf16 (K6) times bf16 weights
                f32_ops = 2 * B * 256 * 64  # the out layer
                ops_by = {"bfloat16": conv_ops + (fc_ops if impl == "fused" else 0),
                          "float32": f32_ops + (fc_ops if impl == "fused1" else 0)}
                bound_ms, bound_by = bound(nbytes(*ops.values(), y), ops_by)
                row = dict(B=B, num_actions=na, max_abs_err=err, tol=tol, argmax_rows_checked=clear, ms=ms,
                           plain_ms=plain_ms, split_ms=split_ms["float32"], split_bf16_ms=split_ms["bfloat16"],
                           library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
                print(f"{name} " + json.dumps(row), flush=True)
                rows.append(dict(row, name=name))
                del parts, ops, y, ref
            del th, stats, obs, patches1
            torch.cuda.empty_cache()
    return rows


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
    return dict(trainer=tr, seconds=seconds, launches=launches, eval_seconds=eval_seconds)


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
    print("rs_generation " + json.dumps(dict(
        seconds=rs["seconds"], timesteps=st.timesteps_so_far, frames_per_s=4 * st.timesteps_so_far / rs["seconds"],
        best_score=rs["trainer"].best_score, peak_memory_gb=rs["peak_bytes"] / 1e9, cut=RS_CUT,
    )), flush=True)
    del rs
    torch.cuda.empty_cache()

    with Phase("K4/K6 vbn_dqn_fused"):
        vbn = check_vbn_fused(device)
    route_launches = {}
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
        del es_run
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
    kernels = [
        entry("population_linear", "deep_neuroevolution_torch/csrc/population_linear.cu",
              "deep_neuroevolution_tpu/ops/pallas_forward.py:59", es_launches, k1, variant=k1["variant"]),
        entry("noise_gradient", "deep_neuroevolution_torch/csrc/noise_gradient.cu",
              "deep_neuroevolution_tpu/ops/pallas_kernels.py:120", es_launches, k2),
        entry("large_dqn_fused_scores", "deep_neuroevolution_torch/csrc/large_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:298", ga_launches, k3_row,
              graph_ms=k3_row["graph_ms"], split_ms=k3_row["split_ms"]),
        entry("vbn_dqn_fused1_scores", "deep_neuroevolution_torch/csrc/vbn_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:147", route_launches["fused1"], k4_row,
              split_ms=k4_row["split_ms"]),
        entry("dqn_conv_chain_fused", "deep_neuroevolution_torch/csrc/dqn_conv_chain.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:422", rs_launches, k5_row,
              einsum_ms=k5_row["einsum_ms"]),
        entry("vbn_dqn_fused_scores", "deep_neuroevolution_torch/csrc/vbn_dqn_fused.cu",
              "deep_neuroevolution_tpu/ops/pallas_fused_dqn.py:471", route_launches["fused"], k6_row,
              split_ms=k6_row["split_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
