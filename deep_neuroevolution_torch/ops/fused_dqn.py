"""K3-K6: per-member fused forwards of the DQNs.

The counterpart of the JAX package's ops/pallas_fused_dqn.py:

* ``large_dqn_fused_scores`` (K3): the whole LargeDQN forward, convs + fc
  + out, one member per CUDA block (csrc/large_dqn_fused.cu: the convs on
  tensor cores, every byte streamed through a ring of bulk copies), on the
  layout that ``LargeDQN.fuse_prepare`` builds → padded scores ``[B, 64]``
  f32, in the JAX kernel's ``fc_mode`` 'fma' (the default) or 'mxu_t' and
  ``conv_mode`` 'scratch' (the default) or 'ksplit';
* ``vbn_dqn_fused1_scores`` (K4) and ``vbn_dqn_fused_scores`` (K6): the
  whole VBN small DQN forward, each normalization folded into a scale a and
  shift c (csrc/vbn_dqn_fused.cu: convs on tensor cores, every byte
  streamed through a ring of bulk copies, on a persistent grid or, at
  small B, with each member split over several blocks as ``vbn_plan``
  says), on the layout that ``VirtualBNDQN.fuse_prepare`` builds (style
  'one' for K4, 'two' for K6) → padded scores ``[B, 64]`` f32;
* ``dqn_conv_chain_fused`` (K5): the conv stack of SmallDQN (2 convs) or
  LargeDQN (3 convs) alone → ``[B, 121, c_out]`` f32
  (csrc/dqn_conv_chain.cu: a persistent grid whose blocks stream their
  members through a ring of bulk copies; bf16 convs on tensor cores); the
  fc stays on K1.

Each wrapper launches its kernel on a CUDA tensor, runs its plain PyTorch
version (``*_plain``) on a CPU tensor and raises on any other device. The
plain versions keep the JAX kernels' rounding points: the operand of every
conv product after the first is rounded to the weight dtype, x3 stays f32
in K3's fc ('mxu_t' rounds it to bf16) and x2 in K4's, K6 rounds x2 to
bf16 before its fc, and the out layers are f32. Sums are f32. K4 and K6
compute h·a + c as a rounded product and a rounded sum, in the kernel as
here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..models.core import extract_patches
from . import _cuda_build

H1, H2 = 21, 11  # conv1 and conv2/conv3 output sizes (84 → 21 → 11)
P1, P2 = H1 * H1, H2 * H2  # 441, 121 output pixels
KK1 = 256  # conv1 patch length 8·8·4
KK2 = 256  # conv2 patch length 4·4·16 of the VBN-DQN
C1, C2, FC = 16, 32, 256  # VBN-DQN widths
LG_C1, LG_C2, LG_C3, LG_FC = 32, 64, 64, 512  # LargeDQN widths
NOUT = 64  # padded action lanes
# K3's modes, as the JAX kernel's (pallas_fused_dqn.py:297-300); the first of each is the default
FC_MODES = ("fma", "mxu_t")
CONV_MODES = ("scratch", "ksplit")

LARGE_OPS = ("patches1", "w1", "b1", "w2", "b2", "w3", "b3", "wf", "bf", "wo", "bo")
# K4's operands in the C function's order; K6 takes "wf" in place of "wf_cm"
VBN_OPS = ("patches1", "w1", "a1", "c1", "w2", "a2", "c2", "wf_cm", "a3", "c3", "wo", "bo")
_VBN_BF16 = ("patches1", "w1", "w2", "wf_cm", "wf")  # read as 16-byte vectors; the rest f32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_GEOMETRIES = ((16, 32, 0), (32, 64, 64))  # SmallDQN, LargeDQN (c1, c2, c3)

FC_ROWS = P2 * C2  # the VBN-DQN fc's rows: 3872
# K4/K6 split each member over S = sm_count // B blocks (S ≥ 2) at
# B ≤ SPLIT_MAX_B, and run one block an SM over whole members above it.
# scripts/torch_k46_ab.py --sweep on an H100 80GB HBM3 (132 SMs, 700 W),
# CUDA-graph ms, one block a member against the split: K4 0.0548 / 0.0458
# at B=33, 0.0559 / 0.0543 at 44, 0.0566 / 0.0598 at 50; K6 0.0607 /
# 0.0581 at 44, 0.0610 / 0.0642 at 50.
SPLIT_MAX_B = 44


@dataclasses.dataclass(frozen=True)
class VbnPlan:
    """How K4 and K6 launch at B members on a card with ``sm_count`` SMs.
    ``split`` = S: blocks a member. S = 1: a persistent grid of ``grid``
    blocks, block i taking members i, i + grid, ... S ≥ 2: ``grid`` = B·S
    blocks, block i being rank i % S of member i // S, which streams the fc
    rows ``rows(i % S)`` and writes their 256 sums to partials[b, s]; the
    member's last block to finish sums its S partial rows in rank order
    (csrc/vbn_dqn_fused.cu's ``unit``)."""

    B: int
    sm_count: int
    split: int
    grid: int

    def rows(self, s: int) -> Tuple[int, int]:
        return s * FC_ROWS // self.split, (s + 1) * FC_ROWS // self.split


def vbn_plan(B: int, sm_count: int) -> VbnPlan:
    """K4's and K6's launch at B members (pure Python, as the C entry
    points compute it)."""
    if B <= 0:
        return VbnPlan(B, sm_count, 1, 0)
    S = sm_count // B if B <= SPLIT_MAX_B else 1
    if S >= 2:
        return VbnPlan(B, sm_count, S, B * S)
    per = -(-B // sm_count)  # ⌈B / SMs⌉ members a block at most
    return VbnPlan(B, sm_count, 1, -(-B // per))


def _conv(x: torch.Tensor, hw: int, k: int, s: int, w: torch.Tensor, b: torch.Tensor,
          ksplit: bool = False) -> torch.Tensor:
    """relu(im2col(x) · w + b) for x ``[B, hw·hw, C]`` f32 (already rounded
    to w's dtype), SAME padding, (i, j, c) patch order. ``ksplit``: each of
    the k·k taps' products ``[B, P, C]·[B, C, O]`` apart, summed in tap
    order (K3's conv_mode 'ksplit')."""
    B, _, c = x.shape
    p = extract_patches(x.reshape(B, hw, hw, c), k, s)
    p = p.reshape(B, p.shape[1] * p.shape[2], -1)
    w = w.float()
    if not ksplit:
        return torch.relu(torch.bmm(p, w) + b.float())
    h = torch.bmm(p[:, :, :c], w[:, :c])
    for t in range(1, k * k):
        h = h + torch.bmm(p[:, :, t * c:(t + 1) * c], w[:, t * c:(t + 1) * c])
    return torch.relu(h + b.float())


def dqn_conv_chain_plain(patches1, w1m, b1, w2m, b2, w3m=None, b3=None, ksplit: bool = False) -> torch.Tensor:
    """K5's plain version; ``ksplit`` sums conv2's and conv3's taps one at a
    time (K3's conv_mode 'ksplit')."""
    x = torch.relu(torch.bmm(patches1.float(), w1m.float()) + b1.float())  # [B, 441, c1]
    x = _conv(x.to(w2m.dtype).float(), H1, 4, 2, w2m, b2, ksplit)  # [B, 121, c2]
    if w3m is not None:
        x = _conv(x.to(w3m.dtype).float(), H2, 3, 1, w3m, b3, ksplit)  # [B, 121, c3]
    return x


def _check_modes(fc_mode: str, conv_mode: str) -> None:
    _require(fc_mode in FC_MODES, f"fc_mode must be one of {FC_MODES}, not {fc_mode!r}")
    _require(conv_mode in CONV_MODES, f"conv_mode must be one of {CONV_MODES}, not {conv_mode!r}")


def large_dqn_fused_scores_plain(ops: Dict[str, torch.Tensor], fc_mode: str = "fma",
                                 conv_mode: str = "scratch") -> torch.Tensor:
    _check_modes(fc_mode, conv_mode)
    x3 = dqn_conv_chain_plain(ops["patches1"], ops["w1"], ops["b1"], ops["w2"], ops["b2"], ops["w3"], ops["b3"],
                              ksplit=conv_mode == "ksplit")
    wf = ops["wf"].float()
    if fc_mode == "fma":
        # fc[n] = Σ_p Σ_c x3[p, c]·wf[c, p, n]: x3 f32, wf widened from bf16
        h = torch.einsum("bpc,bcpn->bn", x3, wf)
    else:
        # 'mxu_t': x3 rounded to bf16, then fc[n] = Σ_c (Σ_p x3[p, c]·wf[c, p, n]), channel by channel
        per_channel = torch.einsum("bpc,bcpn->bcn", x3.to(torch.bfloat16).float(), wf)
        h = per_channel[:, 0]
        for c in range(1, LG_C3):
            h = h + per_channel[:, c]
    x4 = torch.relu(h + ops["bf"][:, 0])
    return torch.bmm(x4[:, None, :], ops["wo"])[:, 0] + ops["bo"][:, 0]


def _vbn_x2(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K4's and K6's convs → x2 ``[B, 121, 32]`` f32: relu(h·a + c) after
    each, conv2's operand x1 rounded to bf16."""
    B = ops["patches1"].shape[0]
    h1 = torch.bmm(ops["patches1"].float(), ops["w1"].float())
    x1 = torch.relu(h1 * ops["a1"] + ops["c1"])  # [B, 441, 16]
    p2 = extract_patches(x1.to(torch.bfloat16).float().reshape(B, H1, H1, C1), 4, 2).reshape(B, P2, KK2)
    return torch.relu(torch.bmm(p2, ops["w2"].float()) * ops["a2"] + ops["c2"])


def _vbn_head(h3: torch.Tensor, ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    x3 = torch.relu(h3 * ops["a3"][:, 0] + ops["c3"][:, 0])
    return torch.bmm(x3[:, None, :], ops["wo"])[:, 0] + ops["bo"][:, 0]


def vbn_dqn_fused1_scores_plain(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    # fc[n] = Σ_c Σ_p x2[p, c]·wf_cm[c, p, n]: x2 f32, wf_cm widened from bf16
    return _vbn_head(torch.einsum("bpc,bcpn->bn", _vbn_x2(ops), ops["wf_cm"].float()), ops)


def vbn_dqn_fused_scores_plain(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    B = ops["patches1"].shape[0]
    xf = _vbn_x2(ops).reshape(B, 1, P2 * C2).to(torch.bfloat16)  # the flatten, rounded to bf16
    return _vbn_head(torch.bmm(xf.float(), ops["wf"].float())[:, 0], ops)


def _require(cond: bool, what: str, exc=ValueError) -> None:
    if not cond:
        raise exc(what)


def _check_common(tensors: Dict[str, torch.Tensor], aligned) -> torch.device:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        _require(t.device == dev, f"{name} on {t.device}, not {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    if dev.type == "cuda":
        for name in aligned:
            _require(tensors[name].data_ptr() % 16 == 0, f"{name} must start 16-byte aligned")
    elif dev.type != "cpu":
        raise ValueError(f"the fused DQN kernels run on cuda or cpu tensors, not {dev}")
    return dev


def _check_large(ops: Dict[str, torch.Tensor]) -> int:
    missing = [k for k in LARGE_OPS if k not in ops]
    _require(not missing, f"large_dqn_fused_scores needs {missing}", KeyError)
    B = ops["patches1"].shape[0]
    shapes = {
        "patches1": (B, P1, KK1), "w1": (B, KK1, LG_C1), "b1": (B, 1, LG_C1),
        "w2": (B, 16 * LG_C1, LG_C2), "b2": (B, 1, LG_C2), "w3": (B, 9 * LG_C2, LG_C3), "b3": (B, 1, LG_C3),
        "wf": (B, LG_C3, P2, LG_FC), "bf": (B, 1, LG_FC), "wo": (B, LG_FC, NOUT), "bo": (B, 1, NOUT),
    }
    for name, shape in shapes.items():
        _require(tuple(ops[name].shape) == shape, f"{name}: shape {tuple(ops[name].shape)}, expected {shape}")
        want = torch.bfloat16 if name in ("patches1", "w1", "w2", "w3", "wf") else torch.float32
        _require(ops[name].dtype == want, f"{name}: dtype {ops[name].dtype}, expected {want}", TypeError)
    return B


def _check_vbn(ops: Dict[str, torch.Tensor], names) -> int:
    missing = [k for k in names if k not in ops]
    _require(not missing, f"the VBN-DQN kernels need {missing}", KeyError)
    B = ops["patches1"].shape[0]
    shapes = {
        "patches1": (B, P1, KK1), "w1": (B, KK1, C1), "a1": (B, 1, C1), "c1": (B, 1, C1),
        "w2": (B, KK2, C2), "a2": (B, 1, C2), "c2": (B, 1, C2), "wf_cm": (B, C2, P2, FC), "wf": (B, P2 * C2, FC),
        "a3": (B, 1, FC), "c3": (B, 1, FC), "wo": (B, FC, NOUT), "bo": (B, 1, NOUT),
    }
    for name in names:
        _require(tuple(ops[name].shape) == shapes[name], f"{name}: shape {tuple(ops[name].shape)}, expected {shapes[name]}")
        want = torch.bfloat16 if name in _VBN_BF16 else torch.float32
        _require(ops[name].dtype == want, f"{name}: dtype {ops[name].dtype}, expected {want}", TypeError)
    return B


def _vbn_launch(fn, ops: Dict[str, torch.Tensor], names, plain, symbol: str) -> torch.Tensor:
    B = _check_vbn(ops, names)
    # the bulk copies' sources: the bf16 operands and wo
    dev = _check_common({k: ops[k] for k in names}, [k for k in names if k in _VBN_BF16 or k == "wo"])
    if dev.type == "cpu":
        return plain(ops)
    out = torch.empty((B, NOUT), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _cuda_build.load()
    ptrs = [ops[k].data_ptr() for k in names]
    stream = _cuda_build.current_stream(dev)
    plan = vbn_plan(B, _cuda_build.sm_count(dev))
    if plan.split == 1:
        err = getattr(lib, symbol)(*ptrs, out.data_ptr(), B, stream)
    else:
        partials = torch.empty((B, plan.split, FC), dtype=torch.float32, device=dev)
        counters = torch.zeros(B, dtype=torch.int32, device=dev)  # a memset node under graph capture
        err = getattr(lib, symbol + "_split")(*ptrs, out.data_ptr(), partials.data_ptr(), counters.data_ptr(), B,
                                              plan.split, stream)
    _cuda_build.check(lib, err, fn.__name__)
    fn.launches += 1
    fn.launches_by_batch[B] = fn.launches_by_batch.get(B, 0) + 1
    return out


def vbn_dqn_fused1_scores(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K4. ``ops``: ``fuse_prepare(style='one')``'s layout plus
    ``patches1`` → padded scores ``[B, 64]`` f32 (lanes past num_actions
    carry the −1e9 bias)."""
    return _vbn_launch(vbn_dqn_fused1_scores, ops, VBN_OPS, vbn_dqn_fused1_scores_plain, "nevo_vbn_dqn_fused1")


vbn_dqn_fused1_scores.launches = 0  # kernel launches since the caller last set it to 0
# the same launches by batch size B; a caller that zeroes .launches clears it too
vbn_dqn_fused1_scores.launches_by_batch = {}


def vbn_dqn_fused_scores(ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """K6. ``ops``: ``fuse_prepare(style='two')``'s layout plus
    ``patches1`` → padded scores ``[B, 64]`` f32."""
    names = tuple("wf" if k == "wf_cm" else k for k in VBN_OPS)
    return _vbn_launch(vbn_dqn_fused_scores, ops, names, vbn_dqn_fused_scores_plain, "nevo_vbn_dqn_fused")


vbn_dqn_fused_scores.launches = 0  # kernel launches since the caller last set it to 0
# the same launches by batch size B; a caller that zeroes .launches clears it too
vbn_dqn_fused_scores.launches_by_batch = {}


def large_dqn_fused_scores(ops: Dict[str, torch.Tensor], fc_mode: str = "fma",
                           conv_mode: str = "scratch") -> torch.Tensor:
    """``ops``: the ``fuse_prepare`` layout plus ``patches1`` → padded scores
    ``[B, 64]`` f32 (lanes past num_actions carry the −1e9 bias).
    ``fc_mode='mxu_t'`` launches the kernel's variant that rounds x3 to bf16
    before the fc; ``conv_mode='ksplit'`` launches the 'scratch' code, whose
    tensor-core sums differ from a tap-by-tap order only in the order of
    float32 sums (csrc/large_dqn_fused.cu)."""
    _check_modes(fc_mode, conv_mode)
    B = _check_large(ops)
    dev = _check_common({k: ops[k] for k in LARGE_OPS}, ("patches1", "w1", "w2", "w3", "wf"))
    if dev.type == "cpu":
        return large_dqn_fused_scores_plain(ops, fc_mode, conv_mode)
    out = torch.empty((B, NOUT), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _cuda_build.load()
    launch = lib.nevo_large_dqn_fused_mxu_t if fc_mode == "mxu_t" else lib.nevo_large_dqn_fused
    err = launch(*(ops[k].data_ptr() for k in LARGE_OPS), out.data_ptr(), B, _cuda_build.current_stream(dev))
    _cuda_build.check(lib, err, "large_dqn_fused_scores")
    fn = large_dqn_fused_scores
    fn.launches += 1
    fn.launches_by_batch[B] = fn.launches_by_batch.get(B, 0) + 1
    mode = f"{fc_mode}/{conv_mode}"
    fn.launches_by_mode[mode] = fn.launches_by_mode.get(mode, 0) + 1
    return out


large_dqn_fused_scores.launches = 0  # kernel launches since the caller last set it to 0
# the same launches by batch size B and by "fc_mode/conv_mode"; a caller
# that zeroes .launches clears them too
large_dqn_fused_scores.launches_by_batch = {}
large_dqn_fused_scores.launches_by_mode = {}


def dqn_conv_chain_fused(patches1, w1m, b1, w2m, b2, w3m=None, b3=None) -> torch.Tensor:
    """The conv stack per member → ``[B, 121, c_out]`` f32. ``patches1``
    ``[B, 441, 256]`` and the weights ``w1m [B, 256, c1]``, ``w2m [B, 16·c1,
    c2]``, ``w3m [B, 9·c2, c3]`` share one dtype (f32 or bf16); the biases
    ``[B, 1, C]`` are f32. (c1, c2, c3) is (16, 32, —) or (32, 64, 64)."""
    B = patches1.shape[0]
    c1, c2 = w1m.shape[-1], w2m.shape[-1]
    c3 = w3m.shape[-1] if w3m is not None else 0
    _require((c1, c2, c3) in _GEOMETRIES, f"conv widths {(c1, c2, c3)}: the kernel takes {_GEOMETRIES}")
    _require((w3m is None) == (b3 is None), "w3m and b3 come together")
    shapes = {"patches1": (B, P1, KK1), "w1m": (B, KK1, c1), "b1": (B, 1, c1), "w2m": (B, 16 * c1, c2),
              "b2": (B, 1, c2)}
    tensors = {"patches1": patches1, "w1m": w1m, "b1": b1, "w2m": w2m, "b2": b2}
    if c3:
        shapes.update(w3m=(B, 9 * c2, c3), b3=(B, 1, c3))
        tensors.update(w3m=w3m, b3=b3)
    for name, shape in shapes.items():
        _require(tuple(tensors[name].shape) == shape, f"{name}: shape {tuple(tensors[name].shape)}, expected {shape}")
    dt = patches1.dtype
    _require(dt in _DTYPE_CODE, f"patches1 must be float32 or bfloat16, got {dt}", TypeError)
    for name, t in tensors.items():
        want = torch.float32 if name.startswith("b") else dt
        _require(t.dtype == want, f"{name}: dtype {t.dtype}, expected {want}", TypeError)
    dev = _check_common(tensors, [k for k in tensors if k.startswith(("patches", "w"))])
    if dev.type == "cpu":
        return dqn_conv_chain_plain(patches1, w1m, b1, w2m, b2, w3m, b3)
    out = torch.empty((B, P2, c3 or c2), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = _cuda_build.load()
    err = lib.nevo_dqn_conv_chain(
        patches1.data_ptr(), w1m.data_ptr(), b1.data_ptr(), w2m.data_ptr(), b2.data_ptr(),
        w3m.data_ptr() if c3 else None, b3.data_ptr() if c3 else None, out.data_ptr(),
        B, c1, c2, c3, _DTYPE_CODE[dt], _cuda_build.current_stream(dev),
    )
    _cuda_build.check(lib, err, "dqn_conv_chain_fused")
    dqn_conv_chain_fused.launches += 1
    by_batch = dqn_conv_chain_fused.launches_by_batch
    by_batch[B] = by_batch.get(B, 0) + 1
    return out


dqn_conv_chain_fused.launches = 0  # kernel launches since the caller last set it to 0
# the same launches by batch size B; a caller that zeroes .launches clears it too
dqn_conv_chain_fused.launches_by_batch = {}
