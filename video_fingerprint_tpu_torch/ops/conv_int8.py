"""K4: the int8 stride-2 convolution of tools/exp_int8_conv.py, with its
fused dequantize + bias + ReLU + requantize epilogue.

    x        (N, H, W, Cin)      int8, or uint8 pixels, shifted to int8 as
                                 x - 128 on load (the probe's conv0 input)
    w        (k, k, Cin, Cout)   int8, HWIO as in the probe, or pack_weight(w)
    w_scale  (Cout,)             f32, per output channel
    bias     (Cout,)             f32
    requant  float or None       the next layer's f32 input scale
    out      (N, Ho, Wo, Cout)   int8 clip(round_half_even(y / requant), -127,
                                 127), or bf16 y when requant is None

    y = relu(float(acc) * w_scale + bias), each f32 step rounded on its own,
    acc the int32 sum of the conv: stride 2, padding k // 2, taps outside the
    frame 0 (int8 0: for uint8 pixels, the pixel value 128).

This is the function of the probe's `conv_int8` (tools/exp_int8_conv.py:79-93),
an XLA int8 conv with its epilogue, not a Pallas kernel. On a CUDA tensor
`conv_int8` launches the hand-written kernel in `csrc/conv_int8.cu`; on a CPU
tensor it runs `conv_int8_plain`, the plain version (im2col and an int32
product: `torch.matmul` on the CPU, `torch._int_mm` on a card). Nothing falls
back: a CUDA input the kernel does not take raises, and so does any other
device. `conv_int8_acc` gives the int32 sums alone (the kernel's check mode).
The kernel takes k = 5 with Cin = 3 (conv0, int8 or uint8) and any odd k with
Cin a multiple of 32 (int8), Cout a multiple of 32. Each launch counts one
`conv_int8.<entry>` (utils/trace.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.utils import trace

K_ALIGN = 32  # the kernel's K chunk: packed weights are zero-padded to it
MODE_INT8, MODE_BF16, MODE_ACC = 0, 1, 2

_lib = None


class PackedWeight(NamedTuple):
    """HWIO int8 weights as the kernel reads them: (Cout, Kpad), K in (dy,
    dx, ci) order, zero past k * k * Cin."""

    matrix: torch.Tensor
    ksize: int
    cin: int


def pack_weight(w: torch.Tensor) -> PackedWeight:
    """(k, k, Cin, Cout) int8 HWIO -> PackedWeight on w's device."""
    if w.dim() != 4 or w.shape[0] != w.shape[1] or w.dtype != torch.int8:
        raise ValueError(f"expected (k, k, Cin, Cout) int8 weights, got {tuple(w.shape)} "
                         f"{w.dtype}")
    k, _, cin, cout = w.shape
    kreal = k * k * cin
    kpad = -(-kreal // K_ALIGN) * K_ALIGN
    matrix = F.pad(w.permute(3, 0, 1, 2).reshape(cout, kreal), (0, kpad - kreal))
    return PackedWeight(matrix.contiguous(), k, cin)


def _packed(w) -> PackedWeight:
    return w if isinstance(w, PackedWeight) else pack_weight(w)


def out_size(size: int, ksize: int) -> int:
    """Output height (or width) of a stride-2 conv with padding k // 2."""
    return (size + 2 * (ksize // 2) - ksize) // 2 + 1


def _as_int8(x: torch.Tensor) -> torch.Tensor:
    """The conv's int8 input: uint8 pixels shifted by -128 (the probe's
    (x.astype(int16) - 128).astype(int8)), int8 as it is."""
    if x.dtype == torch.uint8:
        return (x.to(torch.int16) - 128).to(torch.int8)
    if x.dtype != torch.int8:
        raise TypeError(f"the int8 conv takes int8 or uint8 input, got {x.dtype}")
    return x


def im2col(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """(N, H, W, C) int8 -> (N * Ho * Wo, k * k * C), the zero-padded
    stride-2 patches in (dy, dx, c) order."""
    p = ksize // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    patches = xp.unfold(1, ksize, 2).unfold(2, ksize, 2)  # (N, Ho, Wo, C, dy, dx)
    n, ho, wo = patches.shape[:3]
    return patches.permute(0, 1, 2, 4, 5, 3).reshape(n * ho * wo, -1)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, Cout) int8 -> (M, Cout) int32, exact: an int32
    torch.matmul on the CPU; torch._int_mm on a card, which takes K a
    multiple of 8 and more than 16 rows (both zero-padded here)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    m, k = a.shape
    kp = -(-k // 8) * 8
    rows = max(m, 17)
    a = F.pad(a, (0, kp - k, 0, rows - m))
    b = F.pad(b, (0, 0, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.contiguous())[:m]


def conv_acc_plain(x: torch.Tensor, w) -> torch.Tensor:
    """The int32 sums: (N, H, W, Cin) -> (N, Ho, Wo, Cout)."""
    pw = _packed(w)
    n, h, wd, cin = x.shape
    if cin != pw.cin:
        raise ValueError(f"input has {cin} channels, the weights take {pw.cin}")
    kreal = pw.ksize * pw.ksize * cin
    cols = im2col(_as_int8(x), pw.ksize)
    acc = int_matmul(cols, pw.matrix[:, :kreal].t())
    return acc.reshape(n, out_size(h, pw.ksize), out_size(wd, pw.ksize), -1)


def epilogue_plain(acc: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                   requant: Optional[float] = None) -> torch.Tensor:
    """relu(float(acc) * w_scale + bias) in the probe's order of f32
    operations, each rounded on its own; then int8 (requantized by a true
    division, round half to even, clip to +-127) or bf16."""
    y = torch.relu(acc.float() * w_scale + bias)
    if requant is None:
        return y.to(torch.bfloat16)
    # a tensor divisor: with a Python scalar, PyTorch's CUDA division
    # multiplies by the reciprocal instead (torch.full: no host copy, so a
    # CUDA graph can capture it)
    s = torch.full((), requant, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y / s), -127, 127).to(torch.int8)


def conv_int8_plain(x: torch.Tensor, w, w_scale: torch.Tensor, bias: torch.Tensor,
                    requant: Optional[float] = None) -> torch.Tensor:
    """Plain version of the kernel: im2col, the int32 product, the epilogue."""
    return epilogue_plain(conv_acc_plain(x, w), w_scale, bias, requant)


def _library():
    global _lib
    if _lib is None:
        from video_fingerprint_tpu_torch.ops import _build

        lib = _build.load("conv_int8")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vfp_conv_int8_forward.argtypes = (
            [ptr] * 5 + [i64] + [i32] * 8 + [ctypes.c_float, ptr])
        lib.vfp_conv_int8_forward.restype = i32
        lib.vfp_conv_int8_error_string.argtypes = [i32]
        lib.vfp_conv_int8_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check_cuda_inputs(x: torch.Tensor, pw: PackedWeight, tensors) -> None:
    if x.dim() != 4 or x.shape[3] != pw.cin:
        raise ValueError(f"x must be (N, H, W, {pw.cin}), got {tuple(x.shape)}")
    if x.shape[0] < 1:
        raise ValueError("x holds no frame")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    conv0 = pw.ksize == 5 and pw.cin == 3
    if x.dtype not in ((torch.int8, torch.uint8) if conv0 else (torch.int8,)):
        raise TypeError(f"the int8 conv kernel takes {'int8 or uint8' if conv0 else 'int8'} "
                        f"input for k = {pw.ksize}, Cin = {pw.cin}; got {x.dtype}")
    if not conv0 and pw.cin % 32:
        raise ValueError(f"the int8 conv kernel takes Cin = 3 with k = 5, or Cin a "
                         f"multiple of 32; got Cin = {pw.cin}, k = {pw.ksize}")
    cout = pw.matrix.shape[0]
    if cout % 32:
        raise ValueError(f"the int8 conv kernel takes Cout a multiple of 32, got {cout}")
    for t in (pw.matrix, *tensors):
        if t.device != x.device:
            raise ValueError(f"every input must be on {x.device}, got {t.device}")
    for t in tensors:
        if t.dtype != torch.float32 or t.numel() != cout or not t.is_contiguous():
            raise ValueError(f"w_scale and bias must be {cout} contiguous float32 values")
    if x.data_ptr() % 16 or pw.matrix.data_ptr() % 16:
        raise ValueError("x and the packed weights must be 16-byte aligned")


def _launch(x: torch.Tensor, pw: PackedWeight, w_scale, bias, mode: int,
            requant: float, name: str) -> torch.Tensor:
    _check_cuda_inputs(x, pw, (w_scale, bias))
    n, h, wd, cin = x.shape
    cout = pw.matrix.shape[0]
    dtype = {MODE_INT8: torch.int8, MODE_BF16: torch.bfloat16, MODE_ACC: torch.int32}[mode]
    out = torch.empty((n, out_size(h, pw.ksize), out_size(wd, pw.ksize), cout),
                      dtype=dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.vfp_conv_int8_forward(
            x.data_ptr(), pw.matrix.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, wd, cin, cout, pw.ksize, pw.matrix.shape[1],
            int(x.dtype == torch.uint8), mode, float(requant), stream)
    if err != 0:
        raise RuntimeError("int8 conv kernel launch failed: "
                           + lib.vfp_conv_int8_error_string(err).decode())
    trace.count(f"conv_int8.{name}")
    return out


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise RuntimeError(f"no int8 conv kernel for device {x.device}")


def conv_int8(x: torch.Tensor, w, w_scale: torch.Tensor, bias: torch.Tensor,
              requant: Optional[float] = None) -> torch.Tensor:
    """int8 (requant given) or bf16 (requant None) conv output, NHWC."""
    pw = _packed(w)
    if x.is_cuda:
        mode = MODE_BF16 if requant is None else MODE_INT8
        return _launch(x, pw, w_scale, bias, mode, requant or 0.0, "conv_int8")
    _check_device(x)
    return conv_int8_plain(x, pw, w_scale, bias, requant)


def conv_int8_acc(x: torch.Tensor, w) -> torch.Tensor:
    """The conv's int32 sums, (N, Ho, Wo, Cout): the kernel's check mode."""
    pw = _packed(w)
    if x.is_cuda:
        cout = pw.matrix.shape[0]
        ones = torch.ones(cout, dtype=torch.float32, device=x.device)
        return _launch(x, pw, ones, ones, MODE_ACC, 0.0, "conv_int8_acc")
    _check_device(x)
    return conv_acc_plain(x, pw)
