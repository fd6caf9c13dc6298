"""Atari frame preprocessing on the device.

The counterpart of the JAX package's envs/preprocess.py:69-160, after the
reference's TF graph (gym_tensorflow/atari/tf_atari.py:81-94):

1. NTSC palette → luminance.
2. Max over the previous and current frame (flicker removal).
3. Bilinear resize to 84×84 with align corners, as ``R · img · C`` with two
   constant interpolation matrices.
4. 4-frame stack: reset zero-fills the history and appends the first
   frame; each step shifts left and appends (wrappers/stack_frames.py).

The host engine's ``obs_mode`` (envs/atari.py) says where steps 1-3 run
(``preprocess_obs``): 'indexed' ships indexed-color frame pairs and the
device does all three with the float32 palette (``preprocess_frames``, the
reference's own path); 'gray' has the engine apply the palette as a uint8
LUT (``GRAY_PALETTE_UINT8``, installed with ``HostBatchEnv.set_gray_lut``)
and the device do 2-3 (``preprocess_gray_frames``); 'preproc' has the
engine do 1-3 and round to uint8, and the device only scales
(``scale_preproc_frames``). Each uint8 rounding moves a pixel by at most
0.5/255.

On a CUDA tensor, 'gray' and 'indexed' run steps 1-3 as one hand-written
kernel (``frames_kernel``, csrc/preprocess.cu) and ``stack_step`` as
another (``stack_kernel``); a CPU tensor runs the chains of PyTorch ops
below (``preprocess_gray_frames``, ``preprocess_frames``,
``stack_step_plain``), which the CPU tests hold against the JAX package and
the card tests hold the kernels against. The kernels take the chains'
numbers: the luminance through the same 256-entry table (for 'gray' the
chain's own scale of each byte: it never decreases, so the max commutes
with it), and the resize through the taps of the same interpolation
matrices (``resize_taps``), summed in the matrices' order. Each wrapper
counts its launches in ``.launches``.

Steps 1-3 run in the span ``preprocess.frames``, step 4 in
``preprocess.stack`` (utils/trace.py: recorded only while a profiler runs).

The palette constants are Atari 2600 NTSC hardware data (tf_atari.py:107-141).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import _cuda_build
from ..utils.trace import span

# NTSC→RGB palette, 128 colors interleaved with zeros to 256 entries
# (tf_atari.py:107-141; Atari 2600 hardware palette data)
NTSC_TO_RGB = [
    0x000000, 0, 0x4A4A4A, 0, 0x6F6F6F, 0, 0x8E8E8E, 0,
    0xAAAAAA, 0, 0xC0C0C0, 0, 0xD6D6D6, 0, 0xECECEC, 0,
    0x484800, 0, 0x69690F, 0, 0x86861D, 0, 0xA2A22A, 0,
    0xBBBB35, 0, 0xD2D240, 0, 0xE8E84A, 0, 0xFCFC54, 0,
    0x7C2C00, 0, 0x904811, 0, 0xA26221, 0, 0xB47A30, 0,
    0xC3903D, 0, 0xD2A44A, 0, 0xDFB755, 0, 0xECC860, 0,
    0x901C00, 0, 0xA33915, 0, 0xB55328, 0, 0xC66C3A, 0,
    0xD5824A, 0, 0xE39759, 0, 0xF0AA67, 0, 0xFCBC74, 0,
    0x940000, 0, 0xA71A1A, 0, 0xB83232, 0, 0xC84848, 0,
    0xD65C5C, 0, 0xE46F6F, 0, 0xF08080, 0, 0xFC9090, 0,
    0x840064, 0, 0x97197A, 0, 0xA8308F, 0, 0xB846A2, 0,
    0xC659B3, 0, 0xD46CC3, 0, 0xE07CD2, 0, 0xEC8CE0, 0,
    0x500084, 0, 0x68199A, 0, 0x7D30AD, 0, 0x9246C0, 0,
    0xA459D0, 0, 0xB56CE0, 0, 0xC57CEE, 0, 0xD48CFC, 0,
    0x140090, 0, 0x331AA3, 0, 0x4E32B5, 0, 0x6848C6, 0,
    0x7F5CD5, 0, 0x956FE3, 0, 0xA980F0, 0, 0xBC90FC, 0,
    0x000094, 0, 0x181AA7, 0, 0x2D32B8, 0, 0x4248C8, 0,
    0x545CD6, 0, 0x656FE4, 0, 0x7580F0, 0, 0x8490FC, 0,
    0x001C88, 0, 0x183B9D, 0, 0x2D57B0, 0, 0x4272C2, 0,
    0x548AD2, 0, 0x65A0E1, 0, 0x75B5EF, 0, 0x84C8FC, 0,
    0x003064, 0, 0x185080, 0, 0x2D6D98, 0, 0x4288B0, 0,
    0x54A0C5, 0, 0x65B7D9, 0, 0x75CCEB, 0, 0x84E0FC, 0,
    0x004030, 0, 0x18624E, 0, 0x2D8169, 0, 0x429E82, 0,
    0x54B899, 0, 0x65D1AE, 0, 0x75E7C2, 0, 0x84FCD4, 0,
    0x004400, 0, 0x1A661A, 0, 0x328432, 0, 0x48A048, 0,
    0x5CBA5C, 0, 0x6FD26F, 0, 0x80E880, 0, 0x90FC90, 0,
    0x143C00, 0, 0x355F18, 0, 0x527E2D, 0, 0x6E9C42, 0,
    0x87B754, 0, 0x9ED065, 0, 0xB4E775, 0, 0xC8FC84, 0,
    0x303800, 0, 0x505916, 0, 0x6D762B, 0, 0x88923E, 0,
    0xA0AB4F, 0, 0xB7C25F, 0, 0xCCD86E, 0, 0xE0EC7C, 0,
    0x482C00, 0, 0x694D14, 0, 0x866A26, 0, 0xA28638, 0,
    0xBB9F47, 0, 0xD2B656, 0, 0xE8CC63, 0, 0xFCE070, 0,
]


def _palettes():
    rgb = np.empty((256, 3), np.uint8)
    for i in range(256):
        z = NTSC_TO_RGB[i]
        rgb[i] = [(z >> 16) & 0xFF, (z >> 8) & 0xFF, z & 0xFF]
    rgbf = rgb.astype(np.float32) / 255.0
    return rgbf @ np.array([0.299, 0.587, 0.114], np.float32)  # tf_atari.py:150


GRAYSCALE_PALETTE = _palettes()  # [256] f32 luminance in [0, 1]
# uint8-quantized luminance LUT for the engine-side palette decode
GRAY_PALETTE_UINT8 = np.round(255.0 * GRAYSCALE_PALETTE).astype(np.uint8)


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` align-corners bilinear interpolation matrix
    (src = i·(in−1)/(out−1))."""
    m = np.zeros((out_size, in_size), np.float32)
    scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
    for i in range(out_size):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[i, lo] += 1.0 - w
        m[i, hi] += w
    return m


def resize_taps(in_size: int, out_size: int) -> np.ndarray:
    """``[out_size, 4]`` int32: each output index's taps (lo, hi) and, as
    float32 bits, their weights (w_lo, w_hi), read off the nonzeros of
    ``_interp_matrix(in_size, out_size)``; a row with one nonzero has hi =
    lo and w_hi = 0. The layout of csrc/preprocess.cu's ``Tap``."""
    m = _interp_matrix(in_size, out_size)
    taps = np.zeros((out_size, 4), np.int32)
    weights = taps.view(np.float32)
    for i, row in enumerate(m):
        nz = np.flatnonzero(row)
        taps[i, :2] = nz[0], nz[-1]
        weights[i, 2] = row[nz[0]]
        if len(nz) > 1:
            weights[i, 3] = row[nz[-1]]
    return taps


@functools.lru_cache(maxsize=None)
def _resize_matrices(h: int, w: int, out_h: int, out_w: int, device: torch.device):
    R = torch.from_numpy(_interp_matrix(h, out_h)).to(device)  # [oh, H]
    C = torch.from_numpy(_interp_matrix(w, out_w).T.copy()).to(device)  # [W, ow]
    return R, C


def _resize(gray: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``[B, H, W]`` float32 → ``[B, out_h, out_w, 1]``, align corners."""
    R, C = _resize_matrices(gray.shape[1], gray.shape[2], out_h, out_w, gray.device)
    return torch.matmul(torch.matmul(R, gray), C)[..., None]


@functools.lru_cache(maxsize=None)
def _gray_palette(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(GRAYSCALE_PALETTE).to(device)


# each frame mode's luminance of a byte: 'gray' the chain's scale (float32
# v · float32(1/255)), 'indexed' the palette
LUMA_TABLES = {
    "gray": np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0),
    "indexed": GRAYSCALE_PALETTE,
}


@functools.lru_cache(maxsize=None)
def _kernel_operands(mode: str, h: int, w: int, out_h: int, out_w: int, device: torch.device):
    """The frames kernel's table, taps (rows', then columns') and whether
    the table never decreases, on ``device``."""
    table = LUMA_TABLES[mode]
    taps = np.concatenate([resize_taps(h, out_h), resize_taps(w, out_w)])
    monotone = bool(np.all(np.diff(table) >= 0))
    return torch.from_numpy(table).to(device), torch.from_numpy(taps).to(device), monotone


def frames_kernel(frames: torch.Tensor, mode: str, out_h: int = 84, out_w: int = 84) -> torch.Tensor:
    """``[B, 2, H, W]`` uint8 frames on a CUDA device → ``[B, out_h, out_w,
    1]`` float32: steps 1-3 of ``mode`` ('gray' or 'indexed') in one launch
    of csrc/preprocess.cu. Raises on anything but contiguous uint8 pairs."""
    if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[1] != 2 or not frames.is_contiguous():
        raise ValueError(f"frames_kernel needs contiguous uint8 [B, 2, H, W] frames, not {frames.dtype} "
                         f"{tuple(frames.shape)}")
    B, _, h, w = frames.shape
    out = torch.empty((B, out_h, out_w, 1), dtype=torch.float32, device=frames.device)
    if B == 0:
        return out
    lib = _cuda_build.load()
    table, taps, monotone = _kernel_operands(mode, h, w, out_h, out_w, frames.device)
    err = lib.nevo_preprocess_frames(frames.data_ptr(), table.data_ptr(), taps.data_ptr(), out.data_ptr(), B, h, w,
                                     out_h, out_w, int(monotone), _cuda_build.current_stream(frames.device))
    _cuda_build.check(lib, err, "frames_kernel")
    frames_kernel.launches += 1
    return out


frames_kernel.launches = 0  # launches since the caller last set it to 0


def preprocess_frames(frames: torch.Tensor, out_h: int = 84, out_w: int = 84) -> torch.Tensor:
    """``[B, 2, H, W]`` uint8 indexed-color frames → ``[B, out_h, out_w, 1]``
    float32 in [0, 1]: the float32 palette's luminance, 2-frame max,
    align-corners resize (tf_atari.py:90-94)."""
    gray = _gray_palette(frames.device)[frames.long()]
    return _resize(gray.max(dim=1).values, out_h, out_w)


def preprocess_gray_frames(frames: torch.Tensor, out_h: int = 84, out_w: int = 84) -> torch.Tensor:
    """``[B, 2, H, W]`` uint8 gray frames → ``[B, out_h, out_w, 1]`` float32
    in [0, 1]: 2-frame max, scale, align-corners resize. The max is taken on
    the uint8 values, which gives the same result as taking it after the
    scale."""
    return _resize(frames.max(dim=1).values.to(torch.float32) * (1.0 / 255.0), out_h, out_w)


def scale_preproc_frames(frames: torch.Tensor) -> torch.Tensor:
    """``[B, h, w]`` uint8 frames the engine preprocessed
    (``observe_preproc``) → ``[B, h, w, 1]`` float32 in [0, 1]."""
    return frames.to(torch.float32)[..., None] * (1.0 / 255.0)


def preprocess_obs(frames: torch.Tensor, mode: str, out_h: int = 84, out_w: int = 84) -> torch.Tensor:
    """The device's part for an engine ``obs_mode`` (see the module
    docstring): one observation ``[B, out_h, out_w, 1]`` float32."""
    with span("preprocess.frames"):
        if mode == "preproc":
            return scale_preproc_frames(frames)
        if mode in LUMA_TABLES and frames.is_cuda:
            return frames_kernel(frames, mode, out_h, out_w)
        if mode == "gray":
            return preprocess_gray_frames(frames, out_h, out_w)
        if mode == "indexed":
            return preprocess_frames(frames, out_h, out_w)
    raise ValueError(f"unknown obs_mode {mode!r} (gray|indexed|preproc)")


def stack_reset(frame: torch.Tensor, num_stack: int = 4) -> torch.Tensor:
    """Zero history plus the first frame in the last channel slot."""
    with span("preprocess.stack"):
        zeros = frame.new_zeros(frame.shape[:-1] + (num_stack - 1,))
        return torch.cat([zeros, frame], dim=-1)


def stack_step_plain(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Shift left and append the new frame, as PyTorch ops."""
    return torch.cat([stack[..., 1:], frame], dim=-1)


def stack_kernel(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """``stack_step_plain`` on a CUDA device in one launch of
    csrc/preprocess.cu: a new ``[..., n]`` float32 stack. Raises on
    anything but contiguous float32 ``[..., n]`` and ``[..., 1]`` tensors
    of the same leading shape."""
    if (stack.dtype != torch.float32 or frame.dtype != torch.float32 or not stack.is_contiguous()
            or not frame.is_contiguous() or stack.dim() < 1 or frame.shape != stack.shape[:-1] + (1,)):
        raise ValueError(f"stack_kernel needs contiguous float32 [..., n] and [..., 1] tensors, not {stack.dtype} "
                         f"{tuple(stack.shape)} and {frame.dtype} {tuple(frame.shape)}")
    out = torch.empty_like(stack)
    n = stack.shape[-1]
    P = frame.numel()
    if P == 0:
        return out
    lib = _cuda_build.load()
    err = lib.nevo_stack_push(stack.data_ptr(), frame.data_ptr(), out.data_ptr(), P, n,
                              _cuda_build.current_stream(stack.device))
    _cuda_build.check(lib, err, "stack_kernel")
    stack_kernel.launches += 1
    return out


stack_kernel.launches = 0  # launches since the caller last set it to 0


def stack_step(stack: torch.Tensor, frame: torch.Tensor) -> torch.Tensor:
    """Shift left and append the new frame: ``stack_kernel`` on a CUDA
    tensor, ``stack_step_plain`` on any other."""
    with span("preprocess.stack"):
        if stack.is_cuda:
            return stack_kernel(stack, frame)
        return stack_step_plain(stack, frame)
