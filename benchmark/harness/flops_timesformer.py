"""Operations and bytes of TimeSformer's divided space-time forward, from a
configuration's sizes.

Frozen from the configuration file alone (benchmark/configs/), so a change
to the program cannot move it. Two operations per multiply-add of the patch
embedding, every linear layer, QK^T and PV of both attentions and the
fingerprint head, per window of num_frames frames at its own shapes;
LayerNorm, softmax, GELU, the CLS mean and the other elementwise work are
not counted. At TimeSformer-Base's widths (hidden 768, 12 layers, 12 heads,
MLP 3072, 224 px in patches of 16, 8 frames, embedding 256) a window is
391,660,339,200 operations. The peaks are harness/flops.py's.
"""

from __future__ import annotations

from typing import Dict, Tuple


def shapes(config: dict) -> Tuple[int, int, int, int, int]:
    """(C hidden, T frames, N patches a frame, H heads, D head width)."""
    C, H = config["hidden_size"], config["num_attention_heads"]
    N = (config["frame_size"] // config["patch_size"]) ** 2
    return C, config["num_frames"], N, H, C // H


def window_macs(config: dict) -> Dict[str, int]:
    """Multiply-adds of one window, by term; the per-layer terms are of all
    the layers together."""
    C, T, N, H, D = shapes(config)
    L, I, P = config["num_hidden_layers"], config["intermediate_size"], config["patch_size"]
    return {
        "patch_embedding": T * N * (3 * P * P) * C,
        # qkv, the attention's output projection and temporal_dense, on the N T patch tokens
        "temporal_linear": L * N * T * 5 * C * C,
        # qkv and the output projection, on T frames of 1 + N tokens
        "spatial_linear": L * T * (N + 1) * 4 * C * C,
        # the MLP on the 1 + N T tokens
        "mlp": L * (1 + N * T) * 2 * C * I,
        # QK^T and PV: N H sequences of T, T H sequences of 1 + N
        "temporal_attention": L * N * H * 2 * T * T * D,
        "spatial_attention": L * T * H * 2 * (N + 1) ** 2 * D,
        "head": C * config["embedding_dim"],
    }


def window_flops(config: dict) -> int:
    return 2 * sum(window_macs(config).values())


def k1_least_seconds(config: dict, peak_flops: float, bytes_per_s: float) -> float:
    """K1's least time for one window: for each attention kind the larger of
    its 4 T^2 D operations an instance at the peak and its q, k, v and o
    (T x D each, in the compute dtype) at HBM bandwidth, over every layer."""
    C, T, N, H, D = shapes(config)
    size = 2 if config["precision"] == "bf16" else 4
    least = 0.0
    for instances, t in ((N * H, T), (T * H, N + 1)):
        least += max(instances * 4 * t * t * D / peak_flops,
                     instances * 4 * t * D * size / bytes_per_s)
    return config["num_hidden_layers"] * least
