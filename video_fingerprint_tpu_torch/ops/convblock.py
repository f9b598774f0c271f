"""The conv-block probe's 3x3 stride-2 conv: 64 -> 128 channels, 16x16 -> 8x8,
+ bias + ReLU, in the layouts of tools/exp_pallas_convblock.py.

    x    (64, 16, 16, N) bf16   channels first, frames innermost
    w2d  (128, 576)      bf16   column (3 dy + dx) * 64 + ci
    b    (128, 1)        bf16
    out  (128, 8, 8, N)  bf16   f32 accumulation, relu(acc + b) rounded once

`conv_strided(x, w2d, b)` takes x itself (the TPU kernel `kernel_strided`);
`conv_parity(xe, xo, w2d, b)` takes its even and odd columns
(`split_parity(x)`, the TPU kernel `kernel`). On a CUDA tensor both launch
the hand-written kernel in `csrc/conv3x3s2.cu`; on a CPU tensor they run
`_conv_torch`, the plain version of the same function. Nothing falls back: a
CUDA tensor the kernel cannot take raises, and so does any other device.

The kernel is not on the scan's path: the spatial encoder's convs run in
cuDNN, as the JAX package leaves them to XLA. It is the counterpart of the
probe's kernels, for the probe (tools/convblock_probe.py) and chip_smoke.py.
Each launch counts one `convblock.<entry>` (utils/trace.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.utils import trace

CIN, COUT, HW_IN, HW_OUT = 64, 128, 16, 8
K = 9 * CIN

_lib = None

# Tolerances as (relative to |reference|, absolute). The kernel, the plain
# version and the Pallas kernel sum the same 576 products in f32 in other
# orders and then round once to bf16, so they may differ by one bf16 ulp
# (2^-7 relative). Against an f64 oracle the error is half an ulp plus the
# f32 summation error.
ONE_ULP = (2.0 ** -7, 2.0 ** -10)
VS_F64 = (2.0 ** -8, 1e-4)


def compare(got: torch.Tensor, ref: torch.Tensor, tol) -> tuple:
    """(max |got - ref|, whether every element is within tol of ref)."""
    delta = (got.double() - ref.double()).abs()
    ok = bool((delta <= tol[0] * ref.double().abs() + tol[1]).all())
    return delta.max().item(), ok


def _conv_in(dtype, x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(b + conv) with every input converted to `dtype` and the result
    left in it, as a (128, 8, 8, N) view."""
    w = w2d.to(dtype).reshape(COUT, 3, 3, CIN).permute(0, 3, 1, 2)
    y = F.conv2d(x.to(dtype).permute(3, 0, 1, 2), w, stride=2, padding=1)
    return torch.relu(y + b.to(dtype).reshape(1, COUT, 1, 1)).permute(1, 2, 3, 0)


def f64_oracle(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The function in float64 on the same (bf16) inputs, not rounded."""
    return _conv_in(torch.float64, x, w2d, b)


def split_parity(x: torch.Tensor):
    """(64, 16, 16, N) -> its even and odd columns, two (64, 16, 8, N) views."""
    return x[:, :, 0::2], x[:, :, 1::2]


def hwio_to_w2d(kernel) -> torch.Tensor:
    """A conv weight -> w2d (128, 576) bf16, columns in (dy, dx, ci) order.

    Takes a flax kernel (3, 3, 64, 128) in HWIO order, as the probe does
    (tools/exp_pallas_convblock.py:213), or a torch Conv2d weight
    (128, 64, 3, 3); a numpy array or a tensor (which keeps its device)."""
    k = (kernel if isinstance(kernel, torch.Tensor)
         else torch.from_numpy(np.array(kernel, np.float32)))
    if tuple(k.shape) == (3, 3, CIN, COUT):
        k = k.permute(3, 0, 1, 2)        # HWIO -> (O, dy, dx, I)
    elif tuple(k.shape) == (COUT, CIN, 3, 3):
        k = k.permute(0, 2, 3, 1)        # OIHW -> (O, dy, dx, I)
    else:
        raise ValueError(f"expected a (3, 3, {CIN}, {COUT}) or ({COUT}, {CIN}, 3, 3) "
                         f"weight, got {tuple(k.shape)}")
    return k.to(torch.bfloat16).reshape(COUT, K).contiguous()


def _conv_torch(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: inputs to f32, one f32 conv, + b, ReLU, one rounding to
    bf16. (64, 16, 16, N) -> (128, 8, 8, N). On the card, run it inside
    utils.precision.full_fp32(): cuDNN would otherwise take TF32."""
    return _conv_in(torch.float32, x, w2d, b).to(torch.bfloat16).contiguous()


def _check_shapes(xs, w2d: torch.Tensor, b: torch.Tensor, width: int) -> None:
    n = xs[0].shape[-1] if xs[0].dim() == 4 else 0
    for x in xs:
        if tuple(x.shape) != (CIN, HW_IN, width, n) or n < 1:
            raise ValueError(f"input must be ({CIN}, {HW_IN}, {width}, N >= 1) and all "
                             f"inputs alike, got {[tuple(t.shape) for t in xs]}")
    if tuple(w2d.shape) != (COUT, K):
        raise ValueError(f"w2d must be ({COUT}, {K}), got {tuple(w2d.shape)}")
    if b.numel() != COUT:
        raise ValueError(f"b must hold {COUT} values, got {tuple(b.shape)}")


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise RuntimeError(f"no conv kernel for device {x.device}")


def _library():
    global _lib
    if _lib is None:
        from video_fingerprint_tpu_torch.ops import _build

        lib = _build.load("conv3x3s2")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vfp_conv3x3s2_forward.argtypes = (
            [ptr] * 5 + [i64, i32] + [i64] * 6 + [ptr])
        lib.vfp_conv3x3s2_forward.restype = i32
        lib.vfp_conv3x3s2_error_string.argtypes = [i32]
        lib.vfp_conv3x3s2_error_string.restype = ctypes.c_char_p
        lib.vfp_conv3x3s2_smem_bytes.argtypes = []
        lib.vfp_conv3x3s2_smem_bytes.restype = i32
        _lib = lib
    return _lib


def smem_bytes() -> int:
    """Dynamic shared memory one block of the kernel takes, in bytes."""
    return int(_library().vfp_conv3x3s2_smem_bytes())


def _conv_cuda(name: str, xs, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: xs is (x,) or (xe, xo), all bf16 on one card."""
    device = xs[0].device
    for t in (*xs, w2d, b):
        if t.device != device:
            raise ValueError(f"every input must be on {device}, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the conv kernel takes bfloat16 only, got {t.dtype}")
    for x in xs:
        if x.stride(3) != 1:
            raise ValueError("the frame dimension (last) must have stride 1")
    if not w2d.is_contiguous() or w2d.data_ptr() % 16:
        raise ValueError("w2d must be contiguous and 16-byte aligned")
    if not b.is_contiguous():
        raise ValueError("b must be contiguous")
    n = xs[0].shape[3]
    out = torch.empty((COUT, HW_OUT, HW_OUT, n), dtype=torch.bfloat16, device=device)
    parity = len(xs) == 2
    xa, xb = xs if parity else (xs[0], None)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.vfp_conv3x3s2_forward(
            xa.data_ptr(), None if xb is None else xb.data_ptr(), w2d.data_ptr(),
            b.data_ptr(), out.data_ptr(), n, int(parity),
            *xa.stride()[:3], *(xa if xb is None else xb).stride()[:3], stream)
    if err != 0:
        raise RuntimeError("conv kernel launch failed: "
                           + lib.vfp_conv3x3s2_error_string(err).decode())
    trace.count(f"convblock.{name}")
    return out


def conv_strided(x: torch.Tensor, w2d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """relu(b + conv3x3 stride 2 pad 1 (x)): (64, 16, 16, N) -> (128, 8, 8, N)."""
    _check_shapes((x,), w2d, b, HW_IN)
    if x.is_cuda:
        return _conv_cuda("conv_strided", (x,), w2d, b)
    _check_device(x)
    return _conv_torch(x, w2d, b)


def conv_parity(xe: torch.Tensor, xo: torch.Tensor, w2d: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """The same function on x's even and odd columns, (64, 16, 8, N) each."""
    _check_shapes((xe, xo), w2d, b, HW_IN // 2)
    if xe.is_cuda:
        return _conv_cuda("conv_parity", (xe, xo), w2d, b)
    _check_device(xe)
    x = torch.stack((xe, xo), dim=3).reshape(CIN, HW_IN, HW_IN, xe.shape[3])
    return _conv_torch(x, w2d, b)
