#!/usr/bin/env python3
"""A/B of K5 (deep_neuroevolution_torch's dqn_conv_chain_fused, the DQNs'
conv stack) against another build of its CUDA source, in one process on one
card.

    python scripts/torch_k5_ab.py --other path/to/csrc/dqn_conv_chain.cu

The other source (for example the parent commit's, unpacked with ``git
archive`` together with the headers beside it) is compiled by nvcc into its
own library and called through its ``nevo_dqn_conv_chain`` entry point (the
C interface both builds share). At each shape of ``CASES`` (SmallDQN
float32 at B=128, the random search's per-group shape, and B=256 for both
geometries and types), on first-generation genomes, the script checks both
builds against the plain version (float32 within 1e-5·max|x|, bfloat16
within 1e-3·max|x|, as chip_smoke.py phase 6) and each against a second
launch of itself (bit for bit), then times them in the order other, this,
this, other: back-to-back calls by CUDA events (``ms``) and calls in a CUDA
graph (``graph_ms``), beside the bound. Prints the card and one JSON line
per shape; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_ab import build_other, card, in_turns

# (model, compute dtype, B)
CASES = (("SmallDQN", "float32", 128), ("SmallDQN", "float32", 256), ("LargeDQN", "bfloat16", 256),
         ("SmallDQN", "bfloat16", 256), ("LargeDQN", "float32", 256))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="a dqn_conv_chain.cu to compare against")
    args = ap.parse_args()

    import torch

    from chip_smoke import conv_chain_bound, random_genomes
    from deep_neuroevolution_torch import models, resolve_device
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    other_lib = build_other(args.other, "k5other")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    other_lib.nevo_dqn_conv_chain.argtypes = [vp] * 8 + [i32] * 5 + [vp]
    other_lib.nevo_dqn_conv_chain.restype = i32
    _cuda_build.load()
    print(card(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(5)

    for name, dt, B in CASES:
        cls = getattr(models, name)
        kw = {"forward_impl": "split"} if name == "LargeDQN" else {}
        model = cls(num_actions=4, compute_dtype=dt, conv_impl="fused", **kw)
        parts, _ = model.prepare_batch_params((random_genomes(model, B, gen, dev), None))
        chain = model.conv_chain_args(parts, torch.rand((B, 84, 84, 4), generator=gen, device=dev))
        del parts
        c1, c2 = chain[1].shape[-1], chain[3].shape[-1]
        c3 = chain[5].shape[-1] if len(chain) > 5 else 0
        y_other = torch.empty((B, fk.P2, c3 or c2), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in chain] + [None] * (7 - len(chain))  # w3, b3 unread for the SmallDQN

        def other():
            err = other_lib.nevo_dqn_conv_chain(*ptrs, y_other.data_ptr(), B, c1, c2, c3, 0 if dt == "float32" else 1,
                                                _cuda_build.current_stream(dev))
            if err:
                raise RuntimeError(f"the other dqn_conv_chain: CUDA error {err}")
            return y_other

        def this():
            return fk.dqn_conv_chain_fused(*chain)

        ref = fk.dqn_conv_chain_plain(*chain)
        tol = (1e-5 if dt == "float32" else 1e-3) * float(ref.abs().max())
        errs, repeats = {}, {}
        for f in (other, this):
            first = f().clone()
            errs[f.__name__] = float((first - ref).abs().max())
            repeats[f.__name__] = bool(torch.equal(first, f()))
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{name} {dt} B={B}: {errs} > {tol}")
        if not repeats["this"]:
            raise AssertionError(f"{name} {dt} B={B}: two launches of this kernel on the same inputs differ")
        bound_ms, bound_by = conv_chain_bound(cls, dt, B, chain, y_other)
        print("ab " + json.dumps(dict(model=name, dtype=dt, B=B, **in_turns(other, this), bound_ms=bound_ms,
                                      bound_by=bound_by, errs=errs, tol=tol, bit_identical_repeats=repeats)),
              flush=True)
        del chain, ptrs, y_other, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
