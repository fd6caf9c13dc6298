#!/usr/bin/env python3
"""A/B of K1 (deep_neuroevolution_torch's population_linear) against another
build of its CUDA source, in one process on one card.

    python scripts/torch_k1_ab.py --other path/to/population_linear.cu

The other source (for example the parent commit's csrc/population_linear.cu,
unpacked with ``git archive`` together with the headers beside it) is
compiled by nvcc into its own library and called through its
``nevo_population_linear`` entry point (the C interface both builds
share). At each of K1's five main-path shapes the script checks
both against the plain version (1e-5·max|y|), then times them in the order
other, this, this, other: back-to-back calls by CUDA events (``ms``) and
calls in a CUDA graph (``graph_ms``), beside one ``torch.bmm``. Last, it
times each wrapper's host cost per call at B=4. Prints one JSON line per
shape; needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from torch_ab import build_other, card, host_us, in_turns

SHAPES = [(128, 3872, 256, "float32"), (256, 3872, 256, "bfloat16"), (256, 3872, 256, "float32"),
          (128, 7744, 512, "float32"), (4, 3872, 256, "float32")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path, help="a population_linear.cu to compare against")
    args = ap.parse_args()

    import torch

    from chip_smoke import bound, cuda_ms, graph_ms
    from deep_neuroevolution_torch import resolve_device
    from deep_neuroevolution_torch.ops import _cuda_build
    from deep_neuroevolution_torch.ops import population_linear as pl

    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    other_lib = build_other(args.other, "k1other")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    other_lib.nevo_population_linear.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    other_lib.nevo_population_linear.restype = i32
    _cuda_build.load()
    print(card(), flush=True)
    gen = torch.Generator(device=dev).manual_seed(3)

    for B, K, N, name in SHAPES:
        dt = getattr(torch, name)
        x = torch.rand((B, K), generator=gen, device=dev).to(dt)
        W = torch.randn((B, K, N), generator=gen, device=dev).to(dt)
        y_other = torch.empty((B, N), device=dev)
        code = 0 if name == "float32" else 1

        def other():
            err = other_lib.nevo_population_linear(x.data_ptr(), W.data_ptr(), y_other.data_ptr(), B, K, N, code,
                                                   _cuda_build.current_stream(dev))
            if err:
                raise RuntimeError(f"the other population_linear: CUDA error {err}")
            return y_other

        def this():
            return pl.population_linear(x, W)

        ref = pl.population_linear_plain(x, W)
        tol = 1e-5 * float(ref.abs().max())
        errs = {f.__name__: float((f() - ref).abs().max()) for f in (other, this)}
        if not all(e <= tol for e in errs.values()):
            raise AssertionError(f"{errs} > {tol}")
        s = x.element_size()
        bound_ms, _ = bound(B * K * N * s + B * K * s + B * N * 4, 2 * B * K * N, name)
        bmm = lambda: torch.bmm(x[:, None, :], W)  # noqa: E731
        print("ab " + json.dumps(dict(
            B=B, K=K, N=N, dtype=name, **in_turns(other, this),
            bmm_ms=cuda_ms(bmm, 50), bmm_graph_ms=graph_ms(bmm), bound_ms=bound_ms, errs=errs, tol=tol,
        )), flush=True)
        del x, W, y_other, ref

    # host cost of one call at B=4, no synchronisation inside the loop: the
    # other build behind a wrapper like the one it came with (an output
    # tensor, the current stream, the ctypes call) against this wrapper
    x = torch.rand((4, 3872), generator=gen, device=dev)
    W = torch.randn((4, 3872, 256), generator=gen, device=dev)

    def other_wrapper():
        y = torch.empty((4, 256), dtype=torch.float32, device=dev)
        other_lib.nevo_population_linear(x.data_ptr(), W.data_ptr(), y.data_ptr(), 4, 3872, 256, 0,
                                         torch.cuda.current_stream(dev).cuda_stream)
        return y

    this_wrapper = lambda: pl.population_linear(x, W)  # noqa: E731
    us = [host_us(f) for f in (other_wrapper, this_wrapper, this_wrapper, other_wrapper)]
    print("host_us_per_call " + json.dumps(dict(order="other this this other", us=us)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
