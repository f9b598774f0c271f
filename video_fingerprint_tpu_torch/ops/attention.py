"""Fused masked attention for the temporal attention blocks.

softmax(q k^T / sqrt(D) + key bias) v over many small instances: 8 heads of
D = temporal_dim / 8 per video (32 at the models' default width), T frames
(any T >= 1; the scan's buckets end at its `max_frames`), 4 blocks per
forward. On a CUDA tensor the wrappers launch the hand-written kernel in
`csrc/attention.cu`; on a CPU tensor they run `_attention_torch`, the plain
version of the same function. Nothing falls back: a CUDA tensor the kernel
cannot take raises.

The kernel takes any head width D (`kernel_plan`):

- D = 32 and D = 64 run the narrow kernels as they are, without a copy;
- D < 32, or 32 < D < 64, is zero-padded here to the next of those widths
  and the padded output columns are dropped;
- every D > 64 runs the wide kernel, which walks the head in column chunks
  of 128 (one for 64 < D <= 128, ceil(D / 128) above): a block sums the
  scores over every 128-column piece of q and k and writes its own chunk of
  the output. Columns past D are zero-padded in the kernel's shared
  memory, so these heads pass without a copy.

Zero columns leave q k^T unchanged and the scale stays 1/sqrt(D), so the
padding is exact. The kernel has no backward: it raises when autograd would
need one (train-mode attention is plain torch math, as in the JAX package).

Semantics follow video_fingerprint_tpu/ops/attention.py: scores, bias and
softmax in f32, the bias is the finite finfo(f32).min / 2 for a masked key
(so a fully masked row averages v instead of giving NaN), p is cast to v's
dtype before the PV product, which accumulates in f32, and the output takes
q's dtype. Each launch counts one `k1.launches` (utils/trace.py), and the
query rows of its blocks: `k1.rows_launched`, QUERY_TILE a query tile of
every instance, and `k1.rows_useful`, the instances' own B * H * T.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from video_fingerprint_tpu_torch.utils import trace

KERNEL_WIDTHS = (32, 64, 128)  # tile widths the kernel is instantiated for
QUERY_TILE = 64  # query rows a block owns (kBQ in csrc/attention.cu)
WIDE = KERNEL_WIDTHS[-1]  # the wide kernel's columns per chunk
MASKED_BIAS = torch.finfo(torch.float32).min / 2

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _key_bias(mask: Optional[torch.Tensor], shape, device) -> torch.Tensor:
    if mask is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return torch.where(mask.to(device=device, dtype=torch.bool),
                       torch.tensor(0.0, device=device),
                       torch.tensor(MASKED_BIAS, device=device))


def _attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: (..., T, D) q/k/v and a (..., T) f32 key bias that
    broadcasts over the leading dims. Mirrors `_attention_jnp`; `scale`
    defaults to 1/sqrt(D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + bias.unsqueeze(-2)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


def _library():
    global _lib
    if _lib is None:
        from video_fingerprint_tpu_torch.ops import _build

        lib = _build.load("attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.vfp_attention_forward.argtypes = (
            [ptr] * 5 + [i32] * 5 + [ctypes.c_float] + [i64] * 12 + [ptr])
        lib.vfp_attention_forward.restype = i32
        lib.vfp_error_string.argtypes = [i32]
        lib.vfp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_width(head_dim: int) -> int:
    """The kernel's tile width for a head of `head_dim` columns."""
    return next(width for width in KERNEL_WIDTHS if head_dim <= width or width == WIDE)


def kernel_plan(head_dim: int) -> tuple[int, int, int]:
    """(tile width, column chunks, columns handed to the kernel) for a head
    of `head_dim` columns: the narrow kernels take 32 or 64 columns (a
    narrower head zero-padded here), the wide kernel the head as it is, in
    ceil(D / 128) chunks."""
    width = kernel_width(head_dim)
    if width < WIDE:
        return width, 1, width
    return width, -(-head_dim // WIDE), head_dim


def _at_kernel_width(launch, q, k, v, mask):
    """launch(q, k, v, mask, scale) at the columns `kernel_plan` hands over:
    q/k/v zero-padded from D to 32 or 64 where D is narrower (no copy when
    D is a width or past 64), the scale of the true D, the padded output
    columns dropped."""
    D = q.shape[-1]
    columns = kernel_plan(D)[2]
    scale = 1.0 / math.sqrt(D)
    if columns == D:
        return launch(q, k, v, mask, scale)
    pad = lambda x: F.pad(x, (0, columns - D))
    return launch(pad(q), pad(k), pad(v), mask, scale)[..., :D]


def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel on (B, H, T, D) views; mask is (B, T) or None."""
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device: "
                             f"{tuple(x.shape)} {x.dtype} {x.device} vs "
                             f"{tuple(q.shape)} {q.dtype} {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("the attention kernel has no backward: run the forward under "
                           "torch.no_grad(), or in train mode, whose attention is plain "
                           "torch math")
    return _at_kernel_width(_launch, q, k, v, mask)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """One launch on (B, H, T, D) views.

    q, k and v may be strided views (the head dimension contiguous); the
    output is allocated as (B, T, H, width) and returned as its
    (B, H, T, width) view, so the caller's merge of the heads is free."""
    B, H, T, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}'s head dimension must be contiguous")
    lib = _library()
    if mask is not None:
        if mask.shape != (B, T):
            raise ValueError(f"mask must be {(B, T)}, got {tuple(mask.shape)}")
        mask = mask.to(device=q.device, dtype=torch.bool).contiguous()
    out = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.vfp_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, H, T, D, _DTYPE_CODES[q.dtype], scale,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            stream,
        )
    if err != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.vfp_error_string(err).decode())
    trace.count("k1.launches")
    trace.count("k1.rows_launched", -(-T // QUERY_TILE) * QUERY_TILE * B * H)
    trace.count("k1.rows_useful", B * H * T)
    return out


def _check_device(q: torch.Tensor) -> None:
    if q.device.type != "cpu":
        raise RuntimeError(f"no attention kernel for device {q.device}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(QK^T/sqrt(D))V over (BH, T, D) instances.

    mask: optional (BH, T) bool key-validity mask (False = padding).
    """
    if q.is_cuda:
        return _attention_cuda(q[:, None], k[:, None], v[:, None],
                               mask)[:, 0]
    _check_device(q)
    return _attention_torch(q, k, v, _key_bias(mask, q.shape[:2], q.device))


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, T, D) q/k/v + optional (B, T) key mask -> (B, H, T, D)."""
    if q.is_cuda:
        return _attention_cuda(q, k, v, mask)
    _check_device(q)
    B, _, T, _ = q.shape
    bias = _key_bias(mask, (B, T), q.device)[:, None, :]
    return _attention_torch(q, k, v, bias)
