#!/usr/bin/env python3
"""A/B of K2 (deep_neuroevolution_torch's noise_gradient, the ES gradient)
against another build of its CUDA source, in one process on one card.

    python scripts/torch_k2_ab.py --other path/to/csrc/noise_gradient.cu [--ring]

The other source (for example the parent commit's, unpacked with ``git
archive`` together with the headers beside it) is compiled by nvcc into its
own library and called through its ``nevo_noise_gradient`` entry point (the
C interface both builds share). At each shape of ``CASES`` (B=2500 pairs,
es_atari_config.json's population, and B=256, the smoke run's, on the
reference's 250M-float table, and B=256 on the smoke run's 25M-float
table; D is the ES model's θ size), with uniform offsets plus the first,
the last and an odd one, the script checks both builds against the plain
version (within 1e-5·max|g|) and each against a second launch of itself
(bit for bit), then times through the C entry points, in the order other,
this, this, other: back-to-back calls by CUDA events (``ms``) and calls in a
CUDA graph (``graph_ms``), beside the bound (the union of the slices, read
once) and the L2 floor (B·D·4 bytes over the L2 read rate of chip_smoke.py's
probe, read once at the start). An ablation runs the other build on the
same pairs sorted by offset (the sort outside the timed call), which shows
how much of the gain is the order (L2 reuse) and how much the rest of the
design; this kernel with every offset equal (every byte an L2 hit after the
first pair) shows its own delivery ceiling.

``--ring`` also builds scripts/torch_k2_ring.cu, the ring designs (every
output through a ring of bulk copies, or a tile's first 1024), checks that
each gives this kernel's g bit for bit, and times each in turns against it.
Prints the card and one JSON line per row; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_ab import build_other, card, in_turns

# (pairs, table floats)
CASES = ((2500, 250_000_000), (256, 250_000_000), (256, 25_000_000))
RING_SOURCE = Path(__file__).resolve().parent / "torch_k2_ring.cu"
RING_ENTRIES = {"ring_split": "nevo_noise_gradient", "all_ring": "nevo_noise_gradient_all_ring"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="a noise_gradient.cu to compare against")
    ap.add_argument("--ring", action="store_true", help="time the ring designs of torch_k2_ring.cu too")
    args = ap.parse_args()

    import torch

    from chip_smoke import bound, graph_ms, l2_read_rate, union_bytes
    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.models import VirtualBNDQN
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops.noise_gradient import noise_gradient, noise_gradient_plain

    dev = resolve_device("cuda")
    other_lib = build_other(args.other, "k2other")
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    other_lib.nevo_noise_gradient.argtypes = [vp, vp, vp, i32, i64, vp, vp]
    other_lib.nevo_noise_gradient.restype = i32
    ring_lib = build_other(RING_SOURCE, "k2ring") if args.ring else None
    for name in RING_ENTRIES.values() if ring_lib else ():
        getattr(ring_lib, name).argtypes = [vp, vp, vp, i32, i64, vp, vp]
        getattr(ring_lib, name).restype = i32
    lib = _cuda_build.load()
    print(card(), flush=True)
    l2 = l2_read_rate(dev)
    print("l2_probe " + json.dumps(l2), flush=True)
    D = VirtualBNDQN(num_actions=4).num_params
    gen = torch.Generator(device=dev).manual_seed(3)
    big = torch.randn(max(n for _, n in CASES), generator=gen, device=dev)

    def entry(which, table, idx, w, out, name="nevo_noise_gradient"):
        def call():
            err = getattr(which, name)(table.data_ptr(), idx.data_ptr(), w.data_ptr(), idx.shape[0], D,
                                       out.data_ptr(), _cuda_build.current_stream(dev))
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out
        return call

    def checked(fns, ref, what):
        errs, repeats = {}, {}
        tol = 1e-5 * float(ref.abs().max())
        for name, f in fns.items():
            first = f().clone()
            errs[name] = float((first - ref).abs().max())
            repeats[name] = bool(torch.equal(first, f()))
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{what}: {errs} > {tol}")
        if not repeats["this"]:
            raise AssertionError(f"{what}: two launches of this kernel on the same inputs differ")
        return dict(errs=errs, tol=tol, bit_identical_repeats=repeats)

    for B, count in CASES:
        table = big[:count]
        idx = torch.randint(0, count - D + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        idx[0], idx[1], idx[2] = count - D, 1, 0
        w = torch.randn(B, generator=gen, device=dev)
        order = torch.argsort(idx.long() * B + torch.arange(B, device=dev))
        idx_s, w_s = idx[order].contiguous(), w[order].contiguous()
        ref = noise_gradient_plain(table, idx, w, D)
        g_this = noise_gradient(table, idx, w, D)  # once through the wrapper
        torch.cuda.synchronize()
        outs = [torch.empty(D, device=dev) for _ in range(3)]
        other, this = entry(other_lib, table, idx, w, outs[0]), entry(lib, table, idx, w, outs[1])
        other_sorted = entry(other_lib, table, idx_s, w_s, outs[2])
        chk = checked(dict(other=other, this=this, other_sorted=other_sorted), ref, f"B={B} table={count}")
        chk["wrapper_equals_entry"] = bool(torch.equal(g_this, this()))
        nbytes = union_bytes(idx.cpu(), D) + B * 8 + D * 4
        bound_ms, bound_by = bound(nbytes, 2 * B * D, "float32")
        equal = torch.full_like(idx, int(idx[3]))
        row = dict(B=B, D=D, table=count, **in_turns(other, this), bound_ms=bound_ms, bound_by=bound_by,
                   l2_floor_ms=B * D * 4 / l2["bytes_per_s"] * 1e3,
                   equal_offsets_graph_ms=graph_ms(entry(lib, table, equal, w, outs[2])), **chk)
        print("ab " + json.dumps(row), flush=True)
        turns = dict(in_turns(other_sorted, this), order="other_sorted this this other_sorted")
        print("ab_sorted " + json.dumps(dict(B=B, D=D, table=count, **turns)), flush=True)
        for variant, name in RING_ENTRIES.items() if ring_lib else ():
            ring = entry(ring_lib, table, idx, w, outs[2], name)
            equal_g = bool(torch.equal(ring().clone(), this()))
            turns = dict(in_turns(ring, this), order=f"{variant} this this {variant}")
            print(f"ab_{variant} " + json.dumps(dict(B=B, D=D, table=count, equal=equal_g, **turns)), flush=True)
        del outs, ref, g_this
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
