"""Stage-by-stage profile of the port's Atari population step on the card.

The port's counterpart of scripts/profile_atari_stages.py: each stage of
the population device step timed alone at B members, by the same marginal
method (scripts/marginal_torch.py: K = 2 and K = 10 steps, each K captured
in one CUDA graph and its replays timed with CUDA events; one step costs
(T₁₀ − T₂) / 8), under the JAX script's stage names.

``main`` (``--model small``, the ES path's VBN-DQN, 18 actions):

  rng_frames       ``torch.randint`` of [B, 2, 210, 160] frames on the card,
                   from an explicit generator registered with each graph
  palette          the 256-entry grayscale table gathered on those frames
  preprocess       palette, 2-frame max and the align-corners resize
                   (envs/preprocess.py ``preprocess_obs`` 'indexed': the
                   frames kernel on a card)
  preprocess_gray  the same on gray frames (``preprocess_obs`` 'gray')
  fc_xla_*         the [B, 3872]·[B, 3872, 256] mat-vec as one ``torch.bmm``
                   (f32, bf16; ``_honest`` with the tanh perturbation)
  fc_pallas_*      the same through kernel K1 (``population_linear``)
  conv_batch*      ``batch_conv2d`` conv1 → conv2 (f32, bf16)
  act_old          the split route as B one-member forwards: the JAX
                   script's vmapped per-member forward (``act_parts``) has
                   no counterpart in the port, and a kernel called through
                   ctypes cannot be ``torch.func.vmap``-ed
  act_new*         the split route (K1; f32, bf16), the ES default
  act_folded_bf16  the folded route (K1)
  act_fused1       kernel K4 (``vbn_dqn_fused1_scores``), then argmax
  act_fused        kernel K6 (``vbn_dqn_fused_scores``), then argmax
  act_new_bf16_rerun  act_new_bf16 once more after the others (a run of
                   every stage), as results/profile_stages_r04.json holds it

``main_large`` (``--model large``, the GA's LargeDQN, 18 actions, bf16):

  lg_conv1/2/3     each ``batch_conv2d`` alone; lg_convchain the three
  lg_fc_pallas     K1 on [B, 7744]·[B, 7744, 512]; lg_fc_xla ``torch.bmm``
  lg_forward       ``LargeDQN`` 'auto' (kernel K3 on a card);
                   lg_forward_fused ``forward_impl='fused'`` (K3)
  lg_stack_update  the 4-frame stack update (``stack_step``: the stack
                   kernel on a card) on [B, 84, 84, 1] frames, the
                   rollout's shape (the JAX script fed [B, 84, 84] frames,
                   which stacks along W)
  lg_im2col1       conv1's bf16 im2col; lg_argmax the action argmax

Each step perturbs its input as the JAX script does, so that no step
repeats another's work: ``tanh(x + t)``, ``x·(1 + 1e-3·t)`` (the factor
rounded to x's dtype, as JAX computes it), ``x + t`` and ``obs + 1e-6·t``.
Each stage's ``*_step`` builder is a module-level function that returns
its computation ``t → tensor``; the timer sums that tensor.

No stage syncs with the host, so every one is captured; a capture that
fails raises, and no stage is switched to another timing or skipped. Each
stage's entry in ``notes`` names its timing (``"graph"``, or ``"host clock
(cpu)"``) and the kernel launches of its timed runs (``"launches"``, by
wrapper name); ``notes["race_ms"]`` holds the race's.

Readings beside the times (stderr and the artifact): the folded, fused1
and fused routes' actions against the split route's on the same θ and
frames (``notes``); for the LargeDQN, K3's actions against the split
route's over four frame batches (``on_chip_equivalence``) and the forward
race (scripts/exp_large_fwd_torch.py) at the same B (``race_ms``).
``in_situ_bench`` stays empty: the JAX artifact took it from bench_atari.py,
whose counterpart is the port's benchmark.

With ``--device cpu`` every stage runs its plain version on the host
clock: a check of the control flow, not a measurement.

Output: ``--out`` (default results/profile_stages_torch.json, or
results/profile_stages_large_torch.json with ``--model large``), with the
JAX artifact's keys (results/profile_stages_r04.json,
profile_stages_r04_large.json) plus ``device`` (``utils/machine.py``).

Usage: python scripts/profile_atari_stages_torch.py [--model small|large]
       [--B 256] [--only NAME[,NAME...]] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.envs.preprocess import (  # noqa: E402
    GRAYSCALE_PALETTE, frames_kernel, preprocess_obs, stack_kernel, stack_reset, stack_step)
from deep_neuroevolution_torch.models import LargeDQN, VirtualBNDQN  # noqa: E402
from deep_neuroevolution_torch.models.batchnorm import VBNStats  # noqa: E402
from deep_neuroevolution_torch.models.core import batch_conv2d, extract_patches  # noqa: E402
from deep_neuroevolution_torch.ops import fused_dqn  # noqa: E402
from deep_neuroevolution_torch.ops.fc_matvec import fc_ktiled, fc_whole  # noqa: E402
from deep_neuroevolution_torch.ops.population_linear import population_linear  # noqa: E402
from deep_neuroevolution_torch.utils import machine  # noqa: E402
from marginal_torch import conv_chain_nhwc, fc_bmm, marginal  # noqa: E402

NUM_ACTIONS = 18
FC_SMALL = (3872, 256)  # the VBN-DQN's fc: 11·11·32 → 256
FC_LARGE = (7744, 512)  # the LargeDQN's fc: 11·11·64 → 512
SMALL_STAGES = ("rng_frames", "palette", "preprocess_gray", "preprocess", "fc_xla_f32", "fc_xla_bf16",
                "fc_xla_honest_bf16", "fc_pallas_f32", "fc_pallas_bf16", "conv_batch", "conv_batch_bf16", "act_old",
                "act_new", "act_new_bf16", "act_folded_bf16", "act_fused1", "act_fused")
LARGE_STAGES = ("lg_conv1", "lg_conv2", "lg_conv3", "lg_convchain", "lg_fc_pallas", "lg_fc_xla", "lg_forward",
                "lg_stack_update", "lg_im2col1", "lg_argmax", "lg_forward_fused")
MATCH_BATCHES = 4  # frame batches of the LargeDQN's K3-against-split action match
KERNELS = (population_linear, fused_dqn.vbn_dqn_fused1_scores, fused_dqn.vbn_dqn_fused_scores,  # counted wrappers
           fused_dqn.large_dqn_fused_scores, fused_dqn.dqn_conv_chain_fused, fc_ktiled, fc_whole, frames_kernel,
           stack_kernel)


def scale(t: int, dtype: torch.dtype) -> float:
    """JAX's ``1 + 1e-3·t.astype(dtype)``, rounded as JAX rounds it in
    ``dtype`` (in bf16 it is 1.0 for t < 4)."""
    return float(1 + 1e-3 * torch.tensor(float(t), dtype=dtype))


# ------------------------------------------------------------ the VBN-DQN's

def rng_frames_step(B: int, gen: torch.Generator):
    return lambda t: torch.randint(0, 256, (B, 2, 210, 160), generator=gen, device=gen.device, dtype=torch.int32)


def palette_step(frames: torch.Tensor):
    pal = torch.from_numpy(GRAYSCALE_PALETTE).to(frames.device)
    return lambda t: pal[(frames + t).long()]


def preprocess_step(frames: torch.Tensor, gray: bool):
    mode = "gray" if gray else "indexed"
    return lambda t: preprocess_obs(frames + t, mode, 84, 84)


def fc_step(name: str, x: torch.Tensor, W: torch.Tensor):
    """An ``fc_*`` stage: K1 (``pallas``) or ``torch.bmm`` on x·(1 + 1e-3·t),
    or ``torch.bmm`` on tanh(x + t) (``honest``: a perturbation that cannot
    be hoisted out of the steps)."""
    if "honest" in name:
        return lambda t: fc_bmm(torch.tanh(x + t), W)
    fc = population_linear if "pallas" in name else fc_bmm
    return lambda t: fc(x * scale(t, x.dtype), W)


def conv_batch_step(parts, obs: torch.Tensor, dtype: torch.dtype):
    """conv1 → relu → conv2 → relu on the split route's weights, the input
    and conv1's output rounded to ``dtype``."""
    def step(t):
        x = (obs + 1e-6 * t).to(dtype)
        h1 = torch.relu(batch_conv2d(parts["conv1/w"], x, stride=4)).to(dtype)
        return torch.relu(batch_conv2d(parts["conv2/w"], h1, stride=2))
    return step


def member(tree, b: int):
    """Member b of stacked parts or stats, as a population of one."""
    if torch.is_tensor(tree):
        return tree[b:b + 1]
    if isinstance(tree, dict):
        return {k: member(v, b) for k, v in tree.items()}
    items = [member(v, b) for v in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)


def act_old_step(model: VirtualBNDQN, parts, stats: VBNStats, obs: torch.Tensor):
    """The split route's actions as B one-member forwards."""
    members = [(member(parts, b), member(stats, b)) for b in range(obs.shape[0])]

    def step(t):
        o = obs + 1e-6 * t
        return torch.cat([model.batch_act_parts(p, o[b:b + 1], s) for b, (p, s) in enumerate(members)])
    return step


def act_step(model, parts, ctx, obs: torch.Tensor):
    """``batch_act_parts`` on prepared parts: the split or folded route, or
    the LargeDQN's K3 layout."""
    return lambda t: model.batch_act_parts(parts, obs + 1e-6 * t, ctx)


def act_fused_step(model: VirtualBNDQN, fops, obs: torch.Tensor):
    """K4 (a ``wf_cm`` layout) or K6, then argmax."""
    return lambda t: torch.argmax(model.batch_scores_fused(fops, obs + 1e-6 * t), dim=-1)


# ------------------------------------------------------------- the LargeDQN's

def lg_conv_step(w: torch.Tensor, x: torch.Tensor, stride: int):
    return lambda t: batch_conv2d(w, x + t, stride=stride)


def lg_convchain_step(parts, obs: torch.Tensor):
    return lambda t: conv_chain_nhwc(parts, (obs + 1e-6 * t).to(torch.bfloat16))


def lg_fc_step(name: str, x: torch.Tensor, W: torch.Tensor):
    fc = population_linear if name == "lg_fc_pallas" else fc_bmm
    return lambda t: fc(torch.tanh(x + t), W)


def lg_stack_update_step(stack: torch.Tensor, frame: torch.Tensor):
    return lambda t: stack_step(stack, frame + 1e-6 * t)


def lg_im2col1_step(obs: torch.Tensor):
    return lambda t: extract_patches((obs + 1e-6 * t).to(torch.bfloat16), 8, 4)


def lg_argmax_step(scores: torch.Tensor):
    return lambda t: torch.argmax((scores + t)[:, 0, :], dim=-1)


# ------------------------------------------------------------------ timing

def launched(entry: dict, fn):
    """``fn()``, with the kernel launches it made in ``entry["launches"]``
    (by wrapper name; only those that launched, so none on the CPU)."""
    before = [f.launches for f in KERNELS]
    out = fn()
    entry["launches"] = {f.__name__: f.launches - n for f, n in zip(KERNELS, before) if f.launches > n}
    return out


def time_stage(name: str, fn, device: torch.device, notes: dict, generators=()) -> float:
    """Milliseconds of one step of ``fn`` (summed); its timing and the
    launches of its timed runs in ``notes[name]``."""
    entry = notes.setdefault(name, {})
    entry["timing"] = "graph" if device.type == "cuda" else "host clock (cpu)"
    return launched(entry, lambda: marginal(lambda t: fn(t).sum(), device, generators=generators))


def match(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).float().mean())


def _printed(what: str, value: float) -> float:
    print(f"  [{what}: {value:.4f}]", file=sys.stderr, flush=True)
    return value


def vbn_stats(B: int, device: torch.device) -> VBNStats:
    """The JAX script's stats: zero means and unit inverse deviations."""
    z = lambda c: torch.zeros((B, c), device=device)  # noqa: E731
    o = lambda c: torch.ones((B, c), device=device)  # noqa: E731
    return VBNStats((z(16), z(32), z(256)), (o(16), o(32), o(256)))


def main(B: int = 256, only=None, device=None):
    """The VBN-DQN's stages; returns ``(stages_ms, notes)``."""
    device = resolve_device(device)
    names = None if only is None else set(only.split(","))
    want = lambda n: names is None or n in names  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(0)
    out, notes = {}, {}

    if want("rng_frames"):
        rgen = torch.Generator(device=device).manual_seed(1)
        out["rng_frames"] = time_stage("rng_frames", rng_frames_step(B, rgen), device, notes, generators=(rgen,))

    if any(want(n) for n in ("palette", "preprocess", "preprocess_gray")):
        frames = torch.randint(0, 256, (B, 2, 210, 160), generator=gen, device=device, dtype=torch.int32).to(torch.uint8)
        stages = {"palette": lambda: palette_step(frames), "preprocess_gray": lambda: preprocess_step(frames, True),
                  "preprocess": lambda: preprocess_step(frames, False)}
        for name, mk in stages.items():
            if want(name):
                out[name] = time_stage(name, mk(), device, notes)
        del frames

    fc = [n for n in SMALL_STAGES if n.startswith("fc_") and want(n)]
    if fc:
        W = torch.randn((B,) + FC_SMALL, generator=gen, device=device)
        x = torch.randn((B, FC_SMALL[0]), generator=gen, device=device)
        for name in fc:
            dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
            out[name] = time_stage(name, fc_step(name, x.to(dt), W.to(dt)), device, notes)
        del W, x

    heavy = [n for n in SMALL_STAGES if n.startswith(("conv_", "act_")) and want(n)]
    if heavy:
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
        stats = vbn_stats(B, device)
        split = VirtualBNDQN(num_actions=NUM_ACTIONS, forward_impl="split")
        thetas = split.reinit_theta(torch.randn((B, split.num_params), generator=gen, device=device))
        split_bf16 = VirtualBNDQN(num_actions=NUM_ACTIONS, compute_dtype="bfloat16", forward_impl="split")
        models = {"conv_batch": split, "conv_batch_bf16": split_bf16, "act_old": split, "act_new": split,
                  "act_new_bf16": split_bf16}
        split_actions = split.batch_act_parts(split.prepare_parts(split.unflatten(thetas)), obs, stats)
        for name in heavy:
            if name in models:
                m = models[name]
                parts, st = m.prepare_batch_params((thetas, stats))
                if name.startswith("conv_"):
                    fn = conv_batch_step(parts, obs, m.dtype)
                elif name == "act_old":
                    fn = act_old_step(m, parts, st, obs)
                else:
                    fn = act_step(m, parts, st, obs)
            elif name == "act_folded_bf16":
                m = VirtualBNDQN(num_actions=NUM_ACTIONS, forward_impl="folded", compute_dtype="bfloat16")
                parts, _ = m.prepare_batch_params((thetas, stats))
                notes[name] = {"action_match_vs_split": _printed(
                    "folded vs split action match", match(m.batch_act_parts(parts, obs, None), split_actions))}
                fn = act_step(m, parts, None, obs)
            else:  # act_fused1 (K4, bf16 parts) and act_fused (K6)
                one = name == "act_fused1"
                m = VirtualBNDQN(num_actions=NUM_ACTIONS, forward_impl="fused1" if one else "fused",
                                 compute_dtype="bfloat16" if one else "float32")
                parts = m.fuse_prepare(m.prepare_parts(m.unflatten(thetas)), stats, style="one" if one else "two")
                fn = act_fused_step(m, parts, obs)
                notes[name] = {"action_match_vs_split": _printed(
                    f"{name[4:]} vs split action match", match(fn(0), split_actions))}
            out[name] = time_stage(name, fn, device, notes)
            if name == "act_new_bf16" and names is None:  # again at the end, as the JAX r04 artifact holds it
                rerun = fn
            del parts, fn
        if "act_new_bf16" in heavy and names is None:
            out["act_new_bf16_rerun"] = time_stage("act_new_bf16_rerun", rerun, device, notes)
    return out, notes


def main_large(B: int = 256, only=None, device=None):
    """The LargeDQN's stages; returns ``(stages_ms, notes,
    on_chip_equivalence)``."""
    device = resolve_device(device)
    names = None if only is None else set(only.split(","))
    want = lambda n: names is None or n in names  # noqa: E731
    gen = torch.Generator(device=device).manual_seed(0)
    out, notes, equiv = {}, {}, {}
    split = LargeDQN(num_actions=NUM_ACTIONS, compute_dtype="bfloat16", forward_impl="split")
    thetas = split.reinit_theta(torch.randn((B, split.num_params), generator=gen, device=device))
    parts = split.prepare_parts(split.unflatten(thetas))
    obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
    bf = torch.bfloat16
    convs = {"lg_conv1": ("conv1/w", lambda: obs.to(bf), 4),
             "lg_conv2": ("conv2/w", lambda: torch.rand((B, 21, 21, 32), generator=gen, device=device).to(bf), 2),
             "lg_conv3": ("conv3/w", lambda: torch.rand((B, 11, 11, 64), generator=gen, device=device).to(bf), 1)}
    for name, (wname, x, stride) in convs.items():
        if want(name):
            out[name] = time_stage(name, lg_conv_step(parts[wname], x(), stride), device, notes)
    if want("lg_convchain"):
        out["lg_convchain"] = time_stage("lg_convchain", lg_convchain_step(parts, obs), device, notes)
    fc = [n for n in ("lg_fc_pallas", "lg_fc_xla") if want(n)]
    if fc:
        xf = torch.randn((B, FC_LARGE[0]), generator=gen, device=device).to(bf)
        for name in fc:
            out[name] = time_stage(name, lg_fc_step(name, xf, parts["fc/w"]), device, notes)
        del xf
    for name, impl in (("lg_forward", "auto"), ("lg_forward_fused", "fused")):
        if want(name):
            m = LargeDQN(num_actions=NUM_ACTIONS, compute_dtype="bfloat16", forward_impl=impl)
            fparts, _ = m.prepare_batch_params((thetas, None))
            route = "split" if "__fused_lg__" not in fparts else "K3" if device.type == "cuda" else "K3's plain version"
            notes[name] = {"route": route}
            out[name] = time_stage(name, act_step(m, fparts, None, obs), device, notes)
            if name == "lg_forward":  # K3 (on a card) against the split route, frames of MATCH_BATCHES draws
                matches, diffs = [], []
                for _ in range(MATCH_BATCHES):
                    o = torch.rand((B, 84, 84, 4), generator=gen, device=device)
                    fused_scores = m.batch_scores_fused(fparts["__fused_lg__"], o)[:, :NUM_ACTIONS] \
                        if "__fused_lg__" in fparts else m.batch_scores_parts(fparts, o)
                    split_scores = split.batch_scores_parts(parts, o)
                    matches.append(match(fused_scores.argmax(-1), split_scores.argmax(-1)))
                    diffs.append(float((fused_scores - split_scores).abs().max()))
                equiv = dict(fused_vs_split_action_match=matches,
                             mean_match=_printed("K3 vs split action match", sum(matches) / len(matches)),
                             score_maxdiff=max(diffs), B=B, batches=MATCH_BATCHES,
                             note=f"{notes[name]['route']} ('auto') against the split route (K1's fc) on the same "
                                  "bf16 θ and frames; disagreements are near ties")
            del fparts
    if want("lg_stack_update"):
        frame = torch.rand((B, 84, 84, 1), generator=gen, device=device)
        out["lg_stack_update"] = time_stage("lg_stack_update", lg_stack_update_step(stack_reset(frame), frame),
                                            device, notes)
    if want("lg_im2col1"):
        out["lg_im2col1"] = time_stage("lg_im2col1", lg_im2col1_step(obs), device, notes)
    if want("lg_argmax"):
        scores = torch.rand((B, 1, 64), generator=gen, device=device)
        out["lg_argmax"] = time_stage("lg_argmax", lg_argmax_step(scores), device, notes)
    return out, notes, equiv


def _report(stages_ms: dict, B: int) -> None:
    for k, v in stages_ms.items():
        print(f"{k:18s} {v:8.4f} ms/step  {v / B * 1e3:8.3f} us/member ({B / v * 1e3:,.0f} member-steps/s)",
              file=sys.stderr, flush=True)


def run(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--B", type=int, default=256)
    p.add_argument("--only", default=None)
    p.add_argument("--model", default="small", choices=["small", "large"])
    p.add_argument("--out", default=None, help="default: results/profile_stages[_large]_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    art = {"B": a.B}
    if a.model == "large":
        import exp_large_fwd_torch as race

        stages, notes, equiv = main_large(a.B, a.only, device)
        notes["race_ms"] = {}
        art.update(stages_ms=stages, race_ms=launched(notes["race_ms"], lambda: race.run(a.B, None, device)),
                   in_situ_bench=None, notes=notes, on_chip_equivalence=equiv)
        notes["in_situ_bench"] = "not measured: the JAX artifact took it from bench_atari.py, whose counterpart " \
                                 "is the port's benchmark"
        out = a.out or "results/profile_stages_large_torch.json"
    else:
        stages, notes = main(a.B, a.only, device)
        art.update(host=f"load average at the end: {machine.loadavg()}", notes=notes, stages_ms=stages)
        out = a.out or "results/profile_stages_torch.json"
    _report(stages, a.B)
    art["device"] = machine.describe(device)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps({"B": a.B, "model": a.model, "stages_ms": stages}), flush=True)
    return art


if __name__ == "__main__":
    run()
