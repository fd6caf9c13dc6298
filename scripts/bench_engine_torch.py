"""The port's host engine alone, and the frame upload to the card.

The port's counterpart of scripts/bench_engine.py. It measures, on the
card's host:

1. **Engine frames/s by thread count**: the C++ thread-pooled simulator
   (the port's native/env_engine.cpp, ``HostBatchEnv``) stepping B slots
   with random actions and a gray observation read each step, finished
   slots reset (``resets`` counts them: the same at every thread count, as
   the episodes do not depend on the threads), for the ToyCatch backend and
   for the ALE backend built against the API stub (``build_ale_stub``; a
   counter game, not ALE). Per-core rates size the host pool a deployment
   needs.
2. **The uint8 frame upload** (``--staging``): the copy the rollout makes
   of each group's ``[B, 2, 210, 160]`` frames,
   ``torch.from_numpy(frames).to(device, non_blocking=True)`` from pageable
   host memory (algos/rollout_host.py ``_frames_to``), then a sync.

The deployment model sizes the host side that one card needs: the card's
capability is 4·B frames over the milliseconds of the stage that the ES
generation's default route runs (``CAPABILITY_STAGE``: the split route,
float32) in the profile artifact of scripts/profile_atari_stages_torch.py
(``--profile``), measured on the card that artifact names. A profile taken
on the CPU gives no capability ("not measured").

With ``--device cpu`` the engine rates are the host's as ever, and the
upload is a host copy: a check of the control flow, not a device rate.

Output: ``--out`` (default results/engine_bench_torch.json), with the keys
of results/engine_bench_r04.json plus ``device`` (``utils/machine.py``).

Usage: python scripts/bench_engine_torch.py [--batch 256] [--steps 150]
       [--staging] [--profile PATH] [--device cpu] [--out PATH]
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

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.native.bridge import HostBatchEnv  # noqa: E402
from deep_neuroevolution_torch.native.build import build_ale_stub  # noqa: E402
from deep_neuroevolution_torch.utils import machine  # noqa: E402

# Public per-core ALE throughput range incl. preprocessing overhead: the
# reference fleet achieved ~500 env-frames/s/core end to end (360k / 720,
# BASELINE.md); bare ALE commonly cites 2-6k frames/s/core
ALE_FRAMES_PER_CORE = (500.0, 2000.0, 6000.0)
CAPABILITY_STAGE = "act_new"  # the profile stage the ES generation's default route runs
FRAME_BYTES = 2 * 210 * 160  # uint8 gray frames a slot ships per engine step


def bench_backend(backend: str, arg: str, lib_path=None, batch=256, threads_list=(1, 2, 4), steps=150,
                  frameskip=4) -> dict:
    """Engine steps/s, frames/s and resets at each thread count."""
    out = {}
    for nt in threads_list:
        env = HostBatchEnv(backend, arg, batch, num_threads=nt, lib_path=lib_path)
        try:
            rng = np.random.default_rng(0)
            env.reset(noops=rng.integers(1, 31, size=batch), max_frames=10**9)
            acts = rng.integers(0, env.num_actions, size=(steps, batch)).astype(np.int32)
            env.set_gray_lut(np.arange(256, dtype=np.uint8))
            for t in range(5):  # warm
                env.step(acts[t])
                env.observe_gray()
            t0 = time.perf_counter()
            resets = 0
            for t in range(steps):
                _, done = env.step(acts[t])
                env.observe_gray()
                if done.any():  # keep all slots hot, like the rollout engine
                    idx = np.nonzero(done)[0].astype(np.int32)
                    env.reset(indices=idx, noops=rng.integers(1, 31, size=idx.size), max_frames=10**9)
                    resets += int(idx.size)
            dt = time.perf_counter() - t0
            eng_steps = steps * batch / dt
            out[str(nt)] = {"engine_steps_per_s": eng_steps, "frames_per_s": eng_steps * frameskip, "resets": resets}
            print(f"{backend}[{nt}t] B={batch}: {eng_steps:,.0f} engine-steps/s "
                  f"({eng_steps * frameskip / 1e6:.2f}M frames/s)", file=sys.stderr, flush=True)
        finally:
            env.close()
    return out


def bench_staging(device: torch.device, batch=256, reps=8) -> dict:
    """Seconds and GB/s of one upload of a group's frames, as the rollout
    makes it (a copy on the CPU)."""
    frames = np.random.default_rng(0).integers(0, 256, size=(batch, 2, 210, 160), dtype=np.uint8)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    x = torch.from_numpy(frames).to(device, non_blocking=True, copy=True)  # warm path and allocation
    sync()
    t0 = time.perf_counter()
    for i in range(reps):
        frames[0, 0, 0, 0] = i
        x = torch.from_numpy(frames).to(device, non_blocking=True, copy=True)
        sync()
    dt = (time.perf_counter() - t0) / reps
    del x
    return {"bytes": int(frames.nbytes), "s_per_transfer": dt, "gb_per_s": frames.nbytes / dt / 1e9,
            "platform": device.type}


def deployment_model(profile_path: str) -> dict:
    """Host cores and upload rate that feed the card at the capability the
    profile artifact measured."""
    with open(profile_path) as f:
        prof = json.load(f)
    card, B, ms = prof["device"]["card"], prof["B"], prof["stages_ms"][CAPABILITY_STAGE]
    cap = None if card == "cpu" else 4 * B / (ms / 1e3)
    return {
        "device_capability_frames_per_s": cap,
        "host_to_device_gbps_required": None if cap is None else cap / 4 * FRAME_BYTES / 1e9,
        "host_cores_needed_at_frames_per_core": None if cap is None else {
            str(int(r)): round(cap / r) for r in ALE_FRAMES_PER_CORE},
        "note": (f"capability: 4·B frames over the {CAPABILITY_STAGE} stage's {ms:.4f} ms at B={B} (the ES "
                 f"generation's default route, split, f32) on {card}, from {profile_path}; "
                 if cap is not None else f"capability not measured: the profile {profile_path} ran on the CPU; ")
                + "500 f/s/core = the reference fleet's end-to-end rate (360k/720, BASELINE.md); 2-6k = bare-ALE "
                  "public range. The rate is the device step's alone: the engine, the upload and the update are "
                  "not in it.",
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--staging", action="store_true", help="also measure the uint8 frame upload to the card")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--steps", type=int, default=150, help="engine steps timed at each thread count")
    p.add_argument("--profile", default="results/profile_stages_torch.json",
                   help="scripts/profile_atari_stages_torch.py's artifact, for the card's capability")
    p.add_argument("--out", default="results/engine_bench_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    device = resolve_device(a.device)

    res = {"batch": a.batch}
    res["toy"] = bench_backend("toy", "", batch=a.batch, steps=a.steps)
    res["ale_stub"] = bench_backend("ale", "pong.bin", lib_path=str(build_ale_stub()), batch=a.batch, steps=a.steps)
    res["ale_stub_note"] = ("the engine's ALE backend built against the API stub (native/ale_stub: a scripted "
                            "counter game, not ALE) — measures the engine framework's per-step overhead ceiling, "
                            "not Atari cost")
    if a.staging:
        res["staging_uint8"] = bench_staging(device, batch=a.batch)
    res["deployment_model"] = deployment_model(a.profile)
    res["staging_caveat"] = (("the upload is from pageable host memory, as the rollout's; a pinned buffer is "
                              "not measured here" if device.type == "cuda" else
                              "run on the CPU: a host copy, a check of the control flow, not a device rate")
                             if a.staging else "not run (--staging)")
    res["device"] = machine.describe(device)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({"toy_2t_frames_per_s": res["toy"]["2"]["frames_per_s"], "out": a.out}), flush=True)
    return res


if __name__ == "__main__":
    main()
