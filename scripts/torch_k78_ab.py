#!/usr/bin/env python3
"""A/B of K7 and K8 (deep_neuroevolution_torch's fc_ktiled and fc_whole)
against another build of their CUDA sources, in one process on one card.

    python scripts/torch_k78_ab.py --other DIR

DIR holds another commit's fc_ktiled.cu and fc_whole.cu with the headers
they include (for example the csrc/ of the commit before the bulk variant,
unpacked with ``git archive``). First prints ptxas's report (registers,
spills, shared memory) of this build's csrc/fc_matvec.cu.
Each is compiled by nvcc into its own library and called through its
``nevo_fc_ktiled`` or ``nevo_fc_whole`` entry point (the general variant's
C interface, which both builds share). At the race's shape (256, 7744, 512)
and the odd shape (5, 5000, 200), both bf16, K7 at kt 1024, 2048 and 3872
and K8 are checked against their plain versions (1e-5·max|y|), then timed
in the order other, this, this, other: back-to-back calls by CUDA events
(``ms``) and calls in a CUDA graph (``graph_ms``), beside one ``torch.bmm``
timed both ways and the bound. Then each wrapper's host microseconds per
call at B=4 (no synchronisation inside the loop; this build's plan cached)
beside each build's graph time, at the race's K and at K=64, where both
builds' calls are host-bound, and the parts of a call apart: this
wrapper's shape check, its plan lookup, its output allocation and its
ctypes call (both kernel launches) with the output made beforehand, and
the other build's ctypes call the same way. Prints one JSON line per
comparison; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

from torch_ab import build_other, card, host_us, in_turns

SHAPES = [(256, 7744, 512), (5, 5000, 200)]
TILES = (1024, 2048, 3872, None)  # None: K8


def ptxas_report() -> str:
    """csrc/fc_matvec.cu compiled once more with ``-Xptxas -v``: ptxas's
    lines on each kernel's registers, spills and shared memory."""
    from deep_neuroevolution_torch.ops import _cuda_build

    src = _cuda_build.CSRC_DIR / "fc_matvec.cu"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                            str(Path(tmp) / "fc_matvec.o")], capture_output=True, text=True, check=True)
    keep = ("Compiling entry", "registers", "spill")
    return "\n".join(line for line in r.stderr.splitlines() if any(k in line for k in keep))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="a directory with fc_ktiled.cu and fc_whole.cu")
    args = ap.parse_args()

    import torch

    from chip_smoke import FC_PLAN_FIELDS, bound, cuda_ms, graph_ms
    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import fc_matvec as fm

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    kt_lib = build_other(args.other / "fc_ktiled.cu", "k7other")
    kt_lib.nevo_fc_ktiled.argtypes = [vp] * 3 + [i32] * 5 + [vp]
    whole_lib = build_other(args.other / "fc_whole.cu", "k8other")
    whole_lib.nevo_fc_whole.argtypes = [vp] * 3 + [i32] * 4 + [vp]
    _cuda_build.load()
    print(card(), flush=True)
    print("ptxas fc_matvec.cu\n" + ptxas_report(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)

    def operands(B, K, N):
        x = torch.randn((B, K), generator=gen, device=dev).to(torch.bfloat16)
        W = torch.empty((B, K, N), dtype=torch.bfloat16, device=dev)
        for b in range(B):
            W[b] = torch.randn((K, N), generator=gen, device=dev)
        return x, W

    def other_call(x, W, kt):
        """The other build's entry, behind a wrapper like the one it came
        with (an output tensor, the current stream, the ctypes call)."""
        (B, K), N = x.shape, W.shape[2]
        y = torch.empty((B, N), dtype=torch.float32, device=dev)
        stream = _cuda_build.current_stream(dev)
        if kt is None:
            err = whole_lib.nevo_fc_whole(x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, 1, stream)
        else:
            err = kt_lib.nevo_fc_ktiled(x.data_ptr(), W.data_ptr(), y.data_ptr(), B, K, N, kt, 1, stream)
        if err:
            raise RuntimeError(f"the other build: CUDA error {err}")
        return y

    def this_call(x, W, kt):
        return fm.fc_whole(x, W) if kt is None else fm.fc_ktiled(x, W, kt)

    def plain(x, W, kt):
        return fm.fc_whole_plain(x, W) if kt is None else fm.fc_ktiled_plain(x, W, kt)

    for B, K, N in SHAPES:
        x, W = operands(B, K, N)
        bound_ms, _ = bound(B * K * N * 2 + B * K * 2 + B * N * 4, 2 * B * K * N, "bfloat16")
        bmm = lambda: torch.bmm(x[:, None, :], W)  # noqa: E731
        for kt in TILES:
            ref = plain(x, W, kt)
            tol = 1e-5 * float(ref.abs().max())
            other = lambda kt=kt: other_call(x, W, kt)  # noqa: E731
            this = lambda kt=kt: this_call(x, W, kt)  # noqa: E731
            errs = {name: float((f() - ref).abs().max()) for name, f in (("other", other), ("this", this))}
            if not all(e <= tol for e in errs.values()):
                raise AssertionError(f"{errs} > {tol}")
            print("ab " + json.dumps(dict(
                B=B, K=K, N=N, kernel="fc_whole" if kt is None else f"fc_ktiled kt={kt}",
                plan={k: getattr(fm.plan_for(x, W, kt), k) for k in FC_PLAN_FIELDS}, **in_turns(other, this),
                bmm_ms=cuda_ms(bmm, 50),
                bmm_graph_ms=graph_ms(bmm), bound_ms=bound_ms, errs=errs, tol=tol,
            )), flush=True)
            del ref
        del x, W
        torch.cuda.empty_cache()

    lib = _cuda_build.load()
    for K in (7744, 64):  # the race's K, and one at which both builds' calls are host-bound
        B, N, kt = 4, 512, 2048
        x, W = operands(B, K, N)
        fns = [lambda: other_call(x, W, kt), lambda: fm.fc_ktiled(x, W, kt)]
        us = [host_us(f) for f in (fns[0], fns[1], fns[1], fns[0])]
        p, bulk_args = fm._lookup(x, W, kt)
        assert p.variant == "bulk", p.reason
        buf = torch.empty((B + p.segments, N), dtype=torch.float32, device=dev)
        y_other = torch.empty((B, N), dtype=torch.float32, device=dev)
        stream = _cuda_build.current_stream(dev)
        xp, wp, bp = x.data_ptr(), W.data_ptr(), buf.data_ptr()
        parts = dict(
            check=lambda: fm.check(x, W),
            lookup=lambda: fm._lookup(x, W, kt),
            alloc=lambda: torch.empty((B + p.segments, N), dtype=torch.float32, device=dev),
            ctypes_call=lambda: lib.nevo_fc_bulk(xp, wp, bp + B * N * 4, bp, bulk_args, stream),
            other_ctypes_call=lambda: kt_lib.nevo_fc_ktiled(xp, wp, y_other.data_ptr(), B, K, N, kt, 1, stream),
        )
        print("host_us_per_call " + json.dumps(dict(
            B=B, K=K, N=N, kernel=f"fc_ktiled kt={kt}", order="other this this other", us=us,
            parts_us={name: host_us(f) for name, f in parts.items()}, graph_ms=[graph_ms(f) for f in fns],
        )), flush=True)
        del x, W, buf
    return 0


if __name__ == "__main__":
    sys.exit(main())
