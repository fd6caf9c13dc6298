#!/usr/bin/env python3
"""A/B of K4 and K6 (deep_neuroevolution_torch's vbn_dqn_fused1_scores and
vbn_dqn_fused_scores, the VBN-DQN's whole-net forwards) against another
build of their CUDA source, in one process on one card.

    python scripts/torch_k46_ab.py --other path/to/csrc/vbn_dqn_fused.cu [--sweep]

The other source (for example the parent commit's, unpacked with ``git
archive`` together with the headers beside it) is compiled by nvcc into its
own library and called through its ``nevo_vbn_dqn_fused1`` and
``nevo_vbn_dqn_fused`` entry points (the C interface both builds share),
or, where the other build has them and ``vbn_plan`` splits the members,
through its ``*_split`` entries as the wrapper calls this build's.
At each B of ``BATCHES`` (1, 4 and 8: an eval-episode group of 4 and its
neighbours; 128: an ES round's pipeline group; 256: a round of 256 slots),
on 4-action members around an init θ with the stats of random reference
frames, the script checks both builds against the plain version
(1e-3·max|score|, as chip_smoke.py phase 9) and this build against a
second launch of itself (bit for bit), then times them in the order other,
this, this, other: back-to-back calls (``ms``) and calls in a CUDA graph
(``graph_ms``), beside the bound and this build's launch plan.

``--sweep`` times this build's two launch forms against each other at each
B of ``SWEEP`` (up to half the SMs, where a member can be split over
S = SMs // B ≥ 2 blocks): the persistent grid (the ``nevo_vbn_dqn_fused*``
entry, one block a member) as "other" and the split (the ``*_split``
entry, its counters zeroed by a memset before each launch, as the wrapper
does) as "this". The largest B at which the split still wins is the
plan's switch point, ``ops.fused_dqn.SPLIT_MAX_B``.

Prints the card and one JSON line per case; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_ab import build_other, card, in_turns

BATCHES = (1, 4, 8, 128, 256)
SWEEP = (4, 8, 16, 22, 33, 44, 50, 58, 66)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="a vbn_dqn_fused.cu to compare against")
    ap.add_argument("--sweep", action="store_true", help="time the split against the persistent grid at small B")
    args = ap.parse_args()
    if args.other is None and not args.sweep:
        ap.error("nothing to do: give --other, --sweep or both")

    import torch

    from chip_smoke import VBN_ROUTES, vbn_bound, vbn_random_ops
    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import fused_dqn as fk

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _cuda_build.load()
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    other_lib, other_splits = None, False
    if args.other is not None:
        other_lib = build_other(args.other, "k46other")
        other_splits = hasattr(other_lib, "nevo_vbn_dqn_fused1_split")
        for impl in VBN_ROUTES:
            getattr(other_lib, f"nevo_vbn_dqn_{impl}").argtypes = [vp] * 13 + [i32, vp]
            getattr(other_lib, f"nevo_vbn_dqn_{impl}").restype = i32
            if other_splits:
                getattr(other_lib, f"nevo_vbn_dqn_{impl}_split").argtypes = [vp] * 15 + [i32, i32, vp]
                getattr(other_lib, f"nevo_vbn_dqn_{impl}_split").restype = i32
    print(card(), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(5)
    ref_frames = torch.rand((128, 84, 84, 4), generator=gen, device=dev)

    def entry(library, symbol, ptrs, y, *extra):
        def call():  # on the current stream, which a CUDA graph's capture changes
            err = getattr(library, symbol)(*ptrs, y.data_ptr(), *extra, _cuda_build.current_stream(dev))
            if err:
                raise RuntimeError(f"{symbol}: CUDA error {err}")
            return y
        return call

    def checked(calls: dict, ref, what: str, repeat: tuple) -> dict:
        """Each call against the plain scores (4 actions) and, for the names
        in ``repeat``, against a second launch of itself."""
        tol = 1e-3 * float(ref[:, :4].abs().max())
        errs, repeats = {}, {}
        for name, f in calls.items():
            first = f().clone()
            errs[name] = float((first[:, :4] - ref[:, :4]).abs().max())
            repeats[name] = bool(torch.equal(first, f()))
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{what}: {errs} > {tol}")
        if not all(repeats[name] for name in repeat):
            raise AssertionError(f"{what}: two launches on the same inputs differ")
        return dict(errs=errs, tol=tol, bit_identical_repeats=repeats)

    for impl, (name, plain_name) in VBN_ROUTES.items():
        fn, plain = getattr(fk, name), getattr(fk, plain_name)
        names = fk.VBN_OPS if impl == "fused1" else tuple("wf" if k == "wf_cm" else k for k in fk.VBN_OPS)
        symbol = f"nevo_vbn_dqn_{impl}"
        for B in BATCHES if other_lib is not None else ():
            ops = vbn_random_ops(impl, B, gen, dev, ref_frames)
            y_other = torch.empty((B, fk.NOUT), dtype=torch.float32, device=dev)
            plan = fk.vbn_plan(B, sms)
            ptrs = [ops[k].data_ptr() for k in names]
            if other_splits and plan.split > 1:
                partials = torch.empty((B, plan.split, fk.FC), dtype=torch.float32, device=dev)
                counters = torch.zeros(B, dtype=torch.int32, device=dev)
                split_entry = entry(other_lib, symbol + "_split", ptrs, y_other, partials.data_ptr(),
                                    counters.data_ptr(), B, plan.split)

                def other():
                    counters.zero_()
                    return split_entry()
            else:
                other = entry(other_lib, symbol, ptrs, y_other, B)

            def this():
                return fn(ops)

            checks = checked({"other": other, "this": this}, plain(ops), f"{name} B={B}", ("this",))
            bound_ms, bound_by = vbn_bound(impl, ops, y_other)
            print("ab " + json.dumps(dict(kernel=name, B=B, split=plan.split, grid=plan.grid,
                                          other_split=other_splits and plan.split > 1, **in_turns(other, this),
                                          bound_ms=bound_ms, bound_by=bound_by, **checks)), flush=True)
            del ops, ptrs, y_other
            torch.cuda.empty_cache()
        for B in SWEEP if args.sweep else ():
            S = sms // B
            ops = vbn_random_ops(impl, B, gen, dev, ref_frames)
            ptrs = [ops[k].data_ptr() for k in names]
            y_grid, y_split = (torch.empty((B, fk.NOUT), dtype=torch.float32, device=dev) for _ in range(2))
            partials = torch.empty((B, S, fk.FC), dtype=torch.float32, device=dev)
            counters = torch.zeros(B, dtype=torch.int32, device=dev)
            persistent = entry(lib, symbol, ptrs, y_grid, B)
            split_entry = entry(lib, symbol + "_split", ptrs, y_split, partials.data_ptr(), counters.data_ptr(), B, S)

            def split():
                counters.zero_()
                return split_entry()

            checks = checked({"persistent": persistent, "split": split}, plain(ops), f"{name} sweep B={B}",
                             ("persistent", "split"))
            print("sweep " + json.dumps(dict(kernel=name, B=B, split=S, plan_split=fk.vbn_plan(B, sms).split,
                                             other="persistent", this="split", **in_turns(persistent, split),
                                             **checks)), flush=True)
            del ops, ptrs, y_grid, y_split, partials, counters
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
