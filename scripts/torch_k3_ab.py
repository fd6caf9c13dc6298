#!/usr/bin/env python3
"""A/B of K3 (deep_neuroevolution_torch's large_dqn_fused_scores, the
LargeDQN's whole-net forward) against another build of its CUDA source, in
one process on one card.

    python scripts/torch_k3_ab.py --other path/to/csrc/large_dqn_fused.cu

The other source (for example the parent commit's, unpacked with ``git
archive`` together with the headers beside it) is compiled by nvcc into its
own library and called through its ``nevo_large_dqn_fused`` entry point (the
C interface both builds share). At B=128 (one of the GA's pipeline groups)
and 256, on first-generation GA genomes of a 4-action LargeDQN, the script
checks both against the plain version (1e-3·max|score|, as chip_smoke.py
phase 5) and each against a second launch of itself (bit for bit), then
times them in the order other, this, this, other: back-to-back calls by
CUDA events (``ms``) and calls in a CUDA graph (``graph_ms``), beside the
bytes bound. Prints the card and one JSON line per B; needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_ab import build_other, card, in_turns

BATCHES = (128, 256)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="a large_dqn_fused.cu to compare against")
    args = ap.parse_args()

    import torch

    from chip_smoke import bound, nbytes, random_genomes
    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.models.core import extract_patches
    from deep_neuroevolution_torch.models.dqn import LargeDQN
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    dev = resolve_device("cuda")
    other_lib = build_other(args.other, "k3other")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    other_lib.nevo_large_dqn_fused.argtypes = [vp] * 12 + [i32, vp]
    other_lib.nevo_large_dqn_fused.restype = i32
    _cuda_build.load()
    print(card(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)
    model = LargeDQN(num_actions=4, forward_impl="fused")

    for B in BATCHES:
        th = random_genomes(model, B, gen, dev)
        obs = torch.rand((B, 84, 84, 4), generator=gen, device=dev)
        parts, _ = model.prepare_batch_params((th, None))
        ops = dict(parts["__fused_lg__"], patches1=extract_patches(obs.to(torch.bfloat16), 8, 4).reshape(B, 441, 256))
        del th, parts
        y_other = torch.empty((B, fk.NOUT), dtype=torch.float32, device=dev)

        def other():
            err = other_lib.nevo_large_dqn_fused(*(ops[k].data_ptr() for k in fk.LARGE_OPS), y_other.data_ptr(), B,
                                                 _cuda_build.current_stream(dev))
            if err:
                raise RuntimeError(f"the other large_dqn_fused: CUDA error {err}")
            return y_other

        def this():
            return fk.large_dqn_fused_scores(ops)

        ref = fk.large_dqn_fused_scores_plain(ops)[:, :model.num_actions]
        tol = 1e-3 * float(ref.abs().max())
        errs, repeats = {}, {}
        for f in (other, this):
            first = f()[:, :model.num_actions].clone()
            errs[f.__name__] = float((first - ref).abs().max())
            repeats[f.__name__] = bool(torch.equal(first, f()[:, :model.num_actions]))
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{errs} > {tol}")
        if not repeats["this"]:
            raise AssertionError("two launches of this kernel on the same inputs differ")
        bound_ms, bound_by = bound(nbytes(*ops.values(), y_other), 2 * B * (441 * 256 * 32 + 121 * 512 * 64
                                                                            + 121 * 576 * 64), "bfloat16")
        print("ab " + json.dumps(dict(B=B, num_actions=model.num_actions, **in_turns(other, this), bound_ms=bound_ms,
                                      bound_by=bound_by, errs=errs, tol=tol, bit_identical_repeats=repeats)),
              flush=True)
        del ops, y_other, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
