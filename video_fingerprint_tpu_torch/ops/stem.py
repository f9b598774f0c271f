"""K6: the attention model's frame stem, from the scan's uint8 frames to
conv0's ReLU output, in one kernel.

    frames  (N, H, W, 3)     uint8, the staged frames, contiguous
    w       (32, 3, 5, 5)    conv0's weight (BatchNorm folded), bf16, any strides
    b       (32,)            its bias
    out     (N, Ho, Wo, 32)  bf16 channels last, Ho = ceil(H / 2), Wo = ceil(W / 2):
                             relu(conv5x5, stride 2, pad 2 (table[frames], w) + b)

`table[u]` is `u.to(bf16) / 255.0` computed by PyTorch on the frames' own
device (`normalise_table`), so the conv's inputs are bit for bit those of
the model's `input_from_frames`. The products of bf16 inputs and weights
are summed in f32, the bias is added in f32 and the result rounded to bf16
once (the unfused path rounds the conv's output and again after the bias).

On a CUDA tensor `stem_conv` launches the hand-written kernel in
`csrc/stem.cu`; on a CPU tensor it runs `stem_conv_plain`, the plain version
of the same function. Nothing falls back: a CUDA input the kernel does not
take raises (contiguous, 16-byte aligned frames, H <= 96, W a multiple of
16 up to 96), and so does any other device. Each launch counts one
`stem.launches` and adds N to `stem.frames` and its grid's blocks to
`stem.blocks` (utils/trace.py).
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.utils import trace

COUT, CIN, KSIZE, STRIDE, PAD = 32, 3, 5, 2, 2
MAX_SIDE = 96   # the largest frame side the kernel takes (its shared memory)
W_ALIGN = 16    # the kernel takes frame widths that are multiples of this

_lib = None
_tables: Dict[torch.device, torch.Tensor] = {}
_tables_lock = threading.Lock()
_packs: Dict[Tuple[int, int], tuple] = {}


def out_size(size: int) -> int:
    """Output height (or width) of the 5x5 stride-2 conv with padding 2."""
    return (size + 2 * PAD - KSIZE) // STRIDE + 1


def normalise_table(device) -> torch.Tensor:
    """(256,) bf16: u.to(bf16) / 255.0 for every byte u, by PyTorch's own ops
    on `device` (the model's input_from_frames), built once per device."""
    device = torch.device(device)
    with _tables_lock:
        table = _tables.get(device)
        if table is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the stem's table is built by the first call on a "
                                   "device; make one before capturing a CUDA graph")
            with torch.inference_mode(False):
                u = torch.arange(256, dtype=torch.uint8, device=device)
                table = u.to(torch.bfloat16) / 255.0
            _tables[device] = table
        return table


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(32, 3, 5, 5) conv weight -> the kernel's (5, 4, 2, 32, 2) bf16
    fragments, `w`'s device.

    Kernel row dy is one mma k-step of 16: k = dx * 3 + ci, k = 15 a zero
    weight. Entry [dy, nt, r, lane, h] is B[k][n] of n8 tile nt, with k =
    8 r + 2 (lane % 4) + h and n = 8 nt + lane // 4, the operand layout of
    mma.m16n8k16's B register r. Column n holds channel ((n % 8) // 2) * 8 +
    (n // 8) * 2 + n % 2, so that the accumulators a thread holds for one
    pixel are channels 8 (lane % 4) .. 8 (lane % 4) + 7."""
    if tuple(w.shape) != (COUT, CIN, KSIZE, KSIZE):
        raise ValueError(f"expected a ({COUT}, {CIN}, {KSIZE}, {KSIZE}) weight, "
                         f"got {tuple(w.shape)}")
    rows = w.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(KSIZE, KSIZE * CIN, COUT)
    rows = F.pad(rows, (0, 0, 0, 1))                       # (dy, k, channel)
    # k = (r, t4, h); channel = (g // 2, nt, g % 2); lane = (g // 2, g % 2, t4)
    return rows.reshape(KSIZE, 2, 4, 2, 4, 4, 2).permute(0, 5, 1, 4, 6, 2, 3).reshape(
        KSIZE, 4, 2, 32, 2).contiguous()


def stem_conv_plain(frames: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: the table's bf16 inputs and bf16 weights to f32, one f32
    conv, + the f32 bias, ReLU, one rounding. On the card, run it inside
    utils.precision.full_fp32(): cuDNN would otherwise take TF32."""
    x = normalise_table(frames.device)[frames.long()].permute(0, 3, 1, 2).float()
    y = F.conv2d(x, w.to(torch.bfloat16).float(), stride=STRIDE, padding=PAD)
    y = torch.relu(y + b.to(torch.float32).reshape(1, COUT, 1, 1))
    return y.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def _library():
    global _lib
    if _lib is None:
        from video_fingerprint_tpu_torch.ops import _build

        lib = _build.load("stem")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vfp_stem_forward.argtypes = [ptr] * 5 + [i64, i32, i32, i32, ptr]
        lib.vfp_stem_forward.restype = i32
        lib.vfp_stem_error_string.argtypes = [i32]
        lib.vfp_stem_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(frames: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    if frames.dtype != torch.uint8:
        raise TypeError(f"the stem kernel takes uint8 frames, got {frames.dtype}")
    shape = tuple(frames.shape)
    if not (len(shape) == 4 and shape[0] >= 1 and 1 <= shape[1] <= MAX_SIDE
            and W_ALIGN <= shape[2] <= MAX_SIDE and shape[2] % W_ALIGN == 0
            and shape[3] == CIN and frames.is_contiguous() and frames.data_ptr() % 16 == 0):
        raise ValueError(f"the stem kernel takes contiguous, 16-byte aligned (N >= 1, H, W, "
                         f"3) frames with H <= {MAX_SIDE} and W a multiple of {W_ALIGN} up "
                         f"to {MAX_SIDE}; got {tuple(frames.shape)}, strides "
                         f"{frames.stride()}")
    if tuple(w.shape) != (COUT, CIN, KSIZE, KSIZE) or w.dtype != torch.bfloat16:
        raise ValueError(f"w must be ({COUT}, {CIN}, {KSIZE}, {KSIZE}) bf16, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if b.numel() != COUT or not b.is_floating_point():
        raise ValueError(f"b must hold {COUT} floating-point values, got {tuple(b.shape)} "
                         f"{b.dtype}")
    for t in (w, b):
        if t.device != frames.device:
            raise ValueError(f"every input must be on {frames.device}, got {t.device}")


def packed(w: torch.Tensor, b: torch.Tensor):
    """(pack_weight(w), b in f32), made once for a weight and bias and kept
    while both live and neither changes (storage and version counter): the
    model's frozen conv0 packs on its first forward and never again.
    Inference tensors keep no version counter, so they pack every call."""
    if w.is_inference() or b.is_inference():
        return pack_weight(w), b.to(torch.float32).contiguous()
    key = (id(w), id(b))
    stamp = (w.data_ptr(), w._version, b.data_ptr(), b._version)
    entry = _packs.get(key)
    if entry is None:
        # the entry goes with the first of its tensors to go, before Python
        # can give that tensor's id to another
        weakref.finalize(w, _packs.pop, key, None)
        weakref.finalize(b, _packs.pop, key, None)
    if entry is None or entry[0] != stamp:
        entry = _packs[key] = (stamp, pack_weight(w), b.to(torch.float32).contiguous())
    return entry[1], entry[2]


def _stem_cuda(frames: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check_cuda_inputs(frames, w, b)
    n, h, wd, _ = frames.shape
    device = frames.device
    table = _tables.get(device)
    if table is None:
        table = normalise_table(device)
    wpack, bias = packed(w, b)
    out = torch.empty((n, out_size(h), out_size(wd), COUT), dtype=torch.bfloat16,
                      device=device)
    lib = _library()
    grid = lib.vfp_stem_forward(frames.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                                table.data_ptr(), out.data_ptr(), n, h, wd, device.index,
                                torch.cuda.current_stream(device).cuda_stream)
    if grid <= 0:
        raise RuntimeError("stem kernel launch failed: "
                           + lib.vfp_stem_error_string(-grid).decode())
    trace.count("stem.launches")
    trace.count("stem.frames", n)
    trace.count("stem.blocks", grid)
    return out


def stem_conv(frames: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> conv0's ReLU output, (N, Ho, Wo, 32) bf16."""
    if frames.is_cuda:
        return _stem_cuda(frames, w, b)
    if frames.device.type != "cpu":
        raise RuntimeError(f"no stem kernel for device {frames.device}")
    return stem_conv_plain(frames, w, b)
