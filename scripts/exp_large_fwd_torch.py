"""LargeDQN forward-path variant race of the PyTorch port on the card.

The port's counterpart of scripts/exp_large_fwd.py: the same variants of
the GA-Atari LargeDQN's population forward at B members, timed by the same
marginal method, under the same keys of ``results_ms``:

* the fc, the [B, 7744]·[B, 7744, 512] bf16 mat-vec → f32:
  ``fc_kt1024``, ``fc_kt2048``, ``fc_kt2048_par`` and ``fc_kt3872`` run
  kernel K7 (``fc_ktiled`` of ops/fc_matvec.py, csrc/fc_matvec.cu) with
  that tile of K rows (``_par`` and the 3872 tile's VMEM limit are TPU
  compile options with no counterpart here, so ``fc_kt2048_par`` is K7 at
  2048 again); ``fc_whole`` runs kernel K8 (``fc_whole``, the same
  source); ``fc_xla`` is one ``torch.bmm``, the counterpart of the einsum
  that XLA computed outside any Pallas kernel (its output is bf16, widened
  to f32);
* the conv stack: ``conv_nhwc`` (the port's ``batch_conv2d`` per layer),
  ``conv_cf`` (channels-first im2col products), ``conv_fused`` (the
  frames' im2col, then kernel K5, as ``LargeDQN(conv_impl='fused')`` runs
  it) and ``conv_fused_kernel`` (K5 alone on precomputed patches);
* the whole net, kernel K3, in the JAX kernel's mode pairs: ``fused_fma``
  ('fma', 'ksplit'), ``fused_mxut`` ('mxu_t', 'ksplit') and
  ``fused_scratch`` ('fma', 'scratch');
* ``conv_equiv_maxdiff``: max |conv_nhwc − conv_cf| on the same frames.

Each step perturbs its input as the JAX script does (``tanh(x + t)``,
``obs + 1e-6·t``, ``patches·(1 + 1e-6·t)``), so no step repeats another's
work. The timer is scripts/marginal_torch.py's, which the stage profile
shares: on a card, K = 2 and K = 10 steps are captured in two CUDA graphs
and each graph's replay is timed with CUDA events; one step's time is
(T₁₀ − T₂) / 8, with each T the least over ``REPS`` replays. With
``--device cpu`` the steps run eagerly on the host clock (the plain
versions of the kernels; a check of the control flow, not a measurement).
A failing variant raises.

Output: ``--out`` (default results/exp_large_fwd_torch.json) holds ``B``,
``results_ms`` and ``device`` (the card and the host,
``utils/machine.py``); the same JSON goes to stdout.

Usage: python scripts/exp_large_fwd_torch.py [--only NAME[,NAME...]] [--B 256]
       [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from deep_neuroevolution_torch.device import resolve_device  # noqa: E402
from deep_neuroevolution_torch.models import LargeDQN  # noqa: E402
from deep_neuroevolution_torch.models.core import _same_pads, extract_patches  # noqa: E402
from deep_neuroevolution_torch.ops import fused_dqn as fk  # noqa: E402
from deep_neuroevolution_torch.ops.fc_matvec import (  # noqa: E402,F401 (the race's wrappers, under its names)
    fc_ktiled, fc_ktiled_plain, fc_whole, fc_whole_plain)
from deep_neuroevolution_torch.utils import machine  # noqa: E402
from marginal_torch import CONV_LAYERS, conv_chain_nhwc, fc_bmm, marginal  # noqa: E402,F401 (shared with the stage profile)

FC_K, FC_N = 7744, 512  # the LargeDQN's fc: 11·11·64 → 512
# K3's mode pairs (fc_mode, conv_mode), as exp_large_fwd.py:277-280
FUSED_MODES = {"fused_fma": ("fma", "ksplit"), "fused_mxut": ("mxu_t", "ksplit"), "fused_scratch": ("fma", "scratch")}


# -------------------------------------------------------------- conv variants

def _extract_patches_cf(x: torch.Tensor, k: int, stride: int, padding: str = "SAME"):
    """NCHW im2col: ``[B, C, H, W]`` → ``[B, k·k·C, P]`` with K order (i, j,
    c), matching an HWIO weight reshaped ``[k·k·C, O]``; and H', W'."""
    b, c, h, w = x.shape
    if padding == "SAME":
        (pt, pb), (pl, pr) = _same_pads(h, k, stride), _same_pads(w, k, stride)
        x = F.pad(x, (pl, pr, pt, pb))
        h, w = h + pt + pb, w + pl + pr
    h2 = (h - k) // stride + 1
    w2 = (w - k) // stride + 1
    slices = [
        x[:, :, i:i + (h2 - 1) * stride + 1:stride, j:j + (w2 - 1) * stride + 1:stride]
        for i in range(k)
        for j in range(k)
    ]
    pat = torch.stack(slices, dim=1)  # [B, k·k, C, H', W']
    return pat.reshape(b, k * k * c, h2 * w2), h2, w2


def batch_conv2d_cf(w: torch.Tensor, x_cf: torch.Tensor, stride: int, bias=None) -> torch.Tensor:
    """Channels-first population conv: ``[B, O, K]·[B, K, P]`` with the
    spatial extent as the product's columns. Products of bf16 inputs summed
    in f32; the result is f32 ``[B, O, H', W']``."""
    B, kh, kw, cin, cout = w.shape
    pat, h2, w2 = _extract_patches_cf(x_cf, kh, stride)
    wmat = w.reshape(B, kh * kw * cin, cout).to(pat.dtype)
    y = torch.bmm(wmat.float().transpose(1, 2), pat.float())
    if bias is not None:
        y = y + bias[:, :, None].float()
    return y.reshape(B, cout, h2, w2)


def conv_chain_cf(parts, x: torch.Tensor) -> torch.Tensor:
    """``conv_chain_nhwc`` channels-first: NHWC → NCHW once, back at the end."""
    h = x.permute(0, 3, 1, 2)
    for nm, s in CONV_LAYERS:
        h = torch.relu(batch_conv2d_cf(parts[nm], h, stride=s)).to(torch.bfloat16)
    return h.permute(0, 2, 3, 1)


# --------------------------------------------------------------------- main

def make_fc_operands(B: int, device: torch.device, gen: torch.Generator):
    """The fc's x ``[B, 7744]`` and W ``[B, 7744, 512]``, N(0, 1) in bf16,
    from ``gen``."""
    x = torch.randn((B, FC_K), generator=gen, device=device).to(torch.bfloat16)
    W = torch.empty((B, FC_K, FC_N), dtype=torch.bfloat16, device=device)
    for b in range(B):  # member by member: no f32 copy of the whole W
        W[b] = torch.randn((FC_K, FC_N), generator=gen, device=device)
    return x, W


def make_operands(B: int, device: torch.device, seed: int = 0) -> dict:
    """The race's operands from one seed: the fc's (``make_fc_operands``);
    B LargeDQNs (18 actions) at their initial θ (normc columns, zero
    biases) in bf16 on the split route's parts; frames ``[B, 84, 84, 4]``
    uniform in [0, 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x, W = make_fc_operands(B, device, gen)
    model = LargeDQN(num_actions=18, compute_dtype="bfloat16", forward_impl="split", conv_impl="einsum")
    thetas = model.reinit_theta(torch.randn((B, model.num_params), generator=gen, device=device))
    parts, _ = model.prepare_batch_params((thetas, None))
    del thetas
    obs = torch.rand((B, 84, 84, 4), generator=gen, device=device)
    return dict(x=x, W=W, parts=parts, obs=obs)


def fc_variants():
    """``results_ms`` key → fc(x, W)."""
    return {
        "fc_kt2048": lambda x, W: fc_ktiled(x, W, 2048),
        "fc_kt2048_par": lambda x, W: fc_ktiled(x, W, 2048),
        "fc_kt3872": lambda x, W: fc_ktiled(x, W, 3872),
        "fc_kt1024": lambda x, W: fc_ktiled(x, W, 1024),
        "fc_whole": fc_whole,
        "fc_xla": fc_bmm,
    }


def time_fc(x: torch.Tensor, W: torch.Tensor, names, device: torch.device) -> dict:
    """The fc variants ``names`` (keys of ``fc_variants``) on x, W, timed in
    that order; key → ms of one step."""
    fns = fc_variants()
    return {name: marginal(lambda t, _fn=fns[name]: _fn(torch.tanh(x + t), W).sum(), device) for name in names}


def run(B: int, only, device) -> dict:
    """The race at B members on ``device``; returns ``results_ms`` (key →
    ms, and ``conv_equiv_maxdiff``). ``only``: comma-separated keys."""
    device = resolve_device(device)
    names = None if only is None else set(only.split(","))

    def want(name):
        return names is None or name in names

    ops = make_operands(B, device)
    out = time_fc(ops["x"], ops["W"], [n for n in fc_variants() if want(n)], device)

    parts, obs = ops["parts"], ops["obs"]
    for name, fn in (("conv_nhwc", conv_chain_nhwc), ("conv_cf", conv_chain_cf)):
        if want(name):
            out[name] = marginal(lambda t, _fn=fn: _fn(parts, (obs + 1e-6 * t).to(torch.bfloat16)).float().sum(), device)

    mfused = LargeDQN(num_actions=18, compute_dtype="bfloat16", conv_impl="fused")
    if want("conv_fused"):  # frames → im2col → K5, the route in place
        out["conv_fused"] = marginal(
            lambda t: fk.dqn_conv_chain_fused(*mfused.conv_chain_args(parts, obs + 1e-6 * t)).sum(), device)
    if want("conv_fused_kernel"):  # K5 alone on precomputed patches
        patches, *wb = mfused.conv_chain_args(parts, obs)
        out["conv_fused_kernel"] = marginal(
            lambda t: fk.dqn_conv_chain_fused(patches * (1 + 1e-6 * t), *wb).sum(), device)

    modes = [m for m in FUSED_MODES if want(m)]
    if modes:
        fops = mfused.fuse_prepare(parts)
        fops["patches1"] = extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, fk.P1, fk.KK1)
        for name in modes:
            fc_mode, conv_mode = FUSED_MODES[name]

            def fstep(t, _f=fc_mode, _c=conv_mode):
                o = dict(fops, patches1=fops["patches1"] * (1 + 1e-6 * t))
                return fk.large_dqn_fused_scores(o, fc_mode=_f, conv_mode=_c).sum()

            out[name] = marginal(fstep, device)
        del fops

    if want("conv_equiv"):  # the two conv routes on the same frames
        xb = obs.to(torch.bfloat16)
        a, b = conv_chain_nhwc(parts, xb), conv_chain_cf(parts, xb)
        out["conv_equiv_maxdiff"] = float((a.float() - b.float()).abs().max())
        print(f"  [conv nhwc vs cf max abs diff: {out['conv_equiv_maxdiff']:.2e}]", file=sys.stderr, flush=True)

    for k, v in out.items():
        if k != "conv_equiv_maxdiff":
            print(f"{k:18s} {v:8.4f} ms  {v / B * 1e3:7.3f} us/member", file=sys.stderr, flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--B", type=int, default=256)
    p.add_argument("--only", default=None, help="comma-separated keys of results_ms ('conv_equiv' for the check)")
    p.add_argument("--out", default="results/exp_large_fwd_torch.json")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    results = run(args.B, args.only, device)
    art = {"B": args.B, "results_ms": results, "device": machine.describe(device)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art), flush=True)
    return art


if __name__ == "__main__":
    main()
