"""Lossless inference-time BatchNorm folding, in the reference state_dict layout.

Every eval-mode BatchNorm (y = (x - mean) * scale / sqrt(var + eps) + bias)
is folded into the conv before it:

    W' = W * a,   b' = (b - mean) * a + bias,   a = scale / sqrt(var + eps)

with a broadcast over the conv's output channels (dim 0 of a torch weight).
This is the arithmetic of video_fingerprint_tpu/models/fuse.py::_fold_conv_bn
in numpy float32, so the folded weights equal the JAX package's up to its
(kh, kw, I, O) transpose. The result loads into create_model(fused=True).
The space-to-depth conv0 variant stays out: the reference keeps it off.
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
}
_PAIRS["cnn3d"] = _PAIRS["3d"]


def fuse_state_dict(sd: Mapping[str, np.ndarray], model_type: str = "attention",
                    eps: float = 1e-5) -> Dict[str, np.ndarray]:
    """Standard state_dict -> state_dict of the fused model (no BatchNorm
    entries left), for model_type "attention", "3d" or "cnn3d"."""
    if model_type not in _PAIRS:
        raise ValueError(f"Unknown model type: {model_type}")
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
    return out
