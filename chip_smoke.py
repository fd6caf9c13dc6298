#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deep_neuroevolution_torch) on one CUDA GPU.

    python3 chip_smoke.py

Run from a checkout of the repository; it needs one CUDA device, nvcc and
g++. Phases, each printing its name when it starts and its seconds when it
ends:

1. device and build: the card's name and power limit; nvcc builds the
   kernels and g++ the host engine, side by side;
2. kernel K1 (population_linear) against its plain PyTorch version, float32
   and bfloat16, at the population fc's shape;
3. kernel K2 (noise_gradient) against its plain version at the ES
   gradient's shape, with unaligned offsets and one slice that ends at the
   table's last element;
4. one ES generation of configurations/es_atari_config.json through the
   port's CLI (``main train``) on the ToyCatch engine at the model's full
   width, with the population, cutoff and noise table cut to smoke size.
   Both kernels' launch counters must move, and a small forward on the card
   must agree with the same forward on the CPU.

Every failure raises and the script exits non-zero without its last line.
On success the line before the last is a JSON object with each kernel's
numbers, and the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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


def bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]
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


def check_population_linear(device) -> dict:
    import torch

    from deep_neuroevolution_torch.ops.population_linear import population_linear, population_linear_plain

    gen = torch.Generator(device=device).manual_seed(1)
    out = {}
    # B=256 is the fc's shape with one group of 256 slots; B=128 is what each
    # of the main path's two pipeline groups gives it
    for B, dtype in ((256, torch.float32), (256, torch.bfloat16), (128, torch.float32)):
        K, N = 3872, 256
        x = torch.rand((B, K), generator=gen, device=device).to(dtype)
        W = torch.randn((B, K, N), generator=gen, device=device).to(dtype)
        y = population_linear(x, W)
        ref = population_linear_plain(x, W)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        tol = 1e-5 * float(ref.abs().max())  # float32 sums in another order
        require(bool(torch.isfinite(y).all()), "population_linear returned non-finite values")
        require(err <= tol, f"population_linear B={B} {dtype}: max abs err {err} > {tol}")
        name = str(dtype).replace("torch.", "")
        ms = cuda_ms(lambda: population_linear(x, W), 20)
        plain_ms = cuda_ms(lambda: population_linear_plain(x, W), 10)
        library_ms = cuda_ms(lambda: torch.bmm(x[:, None, :], W), 20)
        s = x.element_size()
        bound_ms, bound_by = bound(B * K * N * s + B * K * s + B * N * 4, 2 * B * K * N, name)
        row = dict(B=B, K=K, N=N, dtype=name, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        print("population_linear " + json.dumps(row), flush=True)
        out[(B, name)] = row
        del x, W, y, ref
    return out[(256, "float32")]


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
    population_linear.launches = 0
    noise_gradient.launches = 0
    t0 = time.perf_counter()
    trainer = cli.cmd_train(cli.build_parser().parse_args(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"population_linear": population_linear.launches, "noise_gradient": noise_gradient.launches}
    print("launches " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        require(n > 0, f"the main path never launched {name}")
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

    # 4 perturbed members of the new θ on 4 reference frames, card vs CPU
    idx = torch.tensor([0, 1, 12345, tr.noise.size - D], dtype=torch.int32)
    thetas = tr.theta[None] + 0.02 * tr.noise.get_batch(idx, D)
    obs = tr.ref_batch[:4]
    card, cpu = (small_forward(tr, thetas, obs, dev) for dev in (tr.device, torch.device("cpu")))
    err = float((card - cpu).abs().max())
    tol = 1e-3 * max(1.0, float(cpu.abs().max()))  # float32, other summation orders
    print(f"forward card vs cpu: max abs err {err:.3g} (tol {tol:.3g})", flush=True)
    require(err <= tol, f"card forward disagrees with the CPU forward: {err} > {tol}")
    top2 = cpu.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    require(bool((card.argmax(-1) == cpu.argmax(-1))[clear].all()), "argmax differs")


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

    def entry(name, source, replaces, k):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": run["launches"][name], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        }

    kernels = [
        entry("population_linear", "deep_neuroevolution_torch/csrc/population_linear.cu",
              "deep_neuroevolution_tpu/ops/pallas_forward.py:59", k1),
        entry("noise_gradient", "deep_neuroevolution_torch/csrc/noise_gradient.cu",
              "deep_neuroevolution_tpu/ops/pallas_kernels.py:120", k2),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
