"""Lossless inference-time BatchNorm folding, in the reference state_dict layout.

Every eval-mode BatchNorm (y = (x - mean) * scale / sqrt(var + eps) + bias)
is folded into the conv before it:

    W' = W * a,   b' = (b - mean) * a + bias,   a = scale / sqrt(var + eps)

with a broadcast over the conv's output channels (dim 0 of a torch weight).
This is the arithmetic of video_fingerprint_tpu/models/fuse.py::_fold_conv_bn
in numpy float32, so the folded weights equal the JAX package's up to its
(kh, kw, I, O) transpose. The result loads into create_model(fused=True).

s2d=True also rewrites the attention model's first conv for the
space-to-depth layout (JAX fuse.py:46-62, fuse_variables(s2d=True)): the
5x5 stride-2 kernel over 3 channels becomes a 3x3 stride-1 kernel over the
12 channels of the 2x2 blocks of the input (`space_to_depth_kernel`); the
result loads into create_model("attention", fused=True, s2d=True). Off by
default, as in the JAX package, whose docstring records it as a loss on a
TPU v5e.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# (conv, bn) state_dict prefixes per model type
_PAIRS = {
    "attention": [(f"spatial_encoder.encoder.{c}", f"spatial_encoder.encoder.{b}")
                  for c, b in [(0, 1), (3, 4), (6, 7), (9, 10)]]
                 + [(f"temporal_conv_blocks.{i}.convs.{j}.0",
                     f"temporal_conv_blocks.{i}.convs.{j}.1")
                    for i in range(2) for j in range(4)],
    "3d": [(f"encoder.{i}.conv", f"encoder.{i}.bn") for i in range(4)],
    "timesformer": [],  # LayerNorm only: nothing to fold
}
_PAIRS["cnn3d"] = _PAIRS["3d"]


def space_to_depth_kernel(k5: np.ndarray) -> np.ndarray:
    """(O, C, 5, 5) stride-2 kernel -> (O, 4C, 3, 3) stride-1 kernel on the
    space-to-depth input, in torch's OIHW layout (JAX space_to_depth_kernel
    in its HWIO layout). Tap (di, dj) lands at block offset (u, v) = (di %
    2, dj % 2), position (dp, dq) = ((di - 2 - u) // 2 + 1, (dj - 2 - v) //
    2 + 1), channel (u * 2 + v) * C + c: the packing of
    layers.space_to_depth, a bijection, so the sums are the same; the
    other taps are zero."""
    O, C, kh, kw = k5.shape
    if (kh, kw) != (5, 5):
        raise ValueError(f"expected a (O, C, 5, 5) kernel, got {k5.shape}")
    k3 = np.zeros((O, 4 * C, 3, 3), dtype=k5.dtype)
    for di in range(5):
        u = di % 2
        dp = (di - 2 - u) // 2 + 1
        for dj in range(5):
            v = dj % 2
            dq = (dj - 2 - v) // 2 + 1
            base = (u * 2 + v) * C
            k3[:, base:base + C, dp, dq] = k5[:, :, di, dj]
    return k3


def fuse_state_dict(sd: Mapping[str, np.ndarray], model_type: str = "attention",
                    eps: float = 1e-5, s2d: bool = False) -> Dict[str, np.ndarray]:
    """Standard state_dict -> state_dict of the fused model (no BatchNorm
    entries left), for model_type "attention", "3d", "cnn3d" or
    "timesformer" (which has no BatchNorm and is returned as it is); s2d=True
    (attention only) also rewrites conv0 for create_model(fused=True,
    s2d=True)."""
    if model_type not in _PAIRS:
        raise ValueError(f"Unknown model type: {model_type}")
    if s2d and model_type != "attention":
        raise ValueError("s2d applies to the attention model's first conv only")
    out = {k: np.asarray(v) for k, v in sd.items()}
    for conv, bn in _PAIRS[model_type]:
        kernel = out[f"{conv}.weight"]
        bias = out[f"{conv}.bias"]
        a = out.pop(f"{bn}.weight") / np.sqrt(out.pop(f"{bn}.running_var") + eps)
        mean = out.pop(f"{bn}.running_mean")
        bn_bias = out.pop(f"{bn}.bias")
        out.pop(f"{bn}.num_batches_tracked", None)
        shape = (-1,) + (1,) * (kernel.ndim - 1)
        out[f"{conv}.weight"] = (kernel * a.reshape(shape)).astype(kernel.dtype)
        out[f"{conv}.bias"] = ((bias - mean) * a + bn_bias).astype(bias.dtype)
    if s2d:
        key = "spatial_encoder.encoder.0.weight"
        out[key] = space_to_depth_kernel(out[key])
    return out
