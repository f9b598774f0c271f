"""Operations and bytes the benchmark's inputs need, from a configuration's sizes.

A frozen copy of the program's analytic count (video_fingerprint_tpu_torch/
utils/flops.py, which counts from the layers of a built model): two
operations per multiply-add of every conv and product, elementwise work,
normalizations and softmax not counted. Here it is computed from the
configuration file alone, so a change to the program cannot move it, and
extended to the 3D model. Every count is of the work a video needs at its
own length (the attention model) or its windows' own lengths (the 3D
model, whose time axis the model itself pads to a multiple of its stride):
never of the padding or the layout the program chooses.

The peaks are NVIDIA's data sheet for one H100 SXM at 700 W: dense bf16
989.4 TFLOP/s, HBM 3.35 TB/s.
"""

from __future__ import annotations

from typing import List, Tuple

BF16_PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12

SPATIAL = ((3, 32, 5, 2), (32, 64, 3, 1), (64, 128, 3, 1), (128, 256, 3, 1))  # in, out, k, pad
CNN3D_CHANNELS = (3, 16, 32, 64, 128)
TEMPORAL_KERNELS = (3, 5, 7, 11)


def element_bytes(config: dict) -> int:
    return 2 if config["precision"] == "bf16" else 4


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def spatial_conv_macs(config: dict) -> List[int]:
    """Multiply-adds of each of the frame CNN's convs on one frame."""
    size, out = config["frame_size"], []
    for cin, cout, k, pad in SPATIAL:
        size = _out(size, k, 2, pad)
        out.append(size * size * cout * cin * k * k)
    return out


def frame_flops(config: dict) -> int:
    """The frame CNN (spatial encoder: convs and its linear) on one frame."""
    return 2 * (sum(spatial_conv_macs(config)) + SPATIAL[-1][1] * config["spatial_dim"])


def head_flops(config: dict, frames: int) -> int:
    """The temporal head on one video of `frames` frames: the projection, the
    grouped temporal convs, each attention block's projections, MLP and its
    QK^T and PV over all heads, the pooling logits, the final projection."""
    S, C, E = config["spatial_dim"], config["temporal_dim"], config["embedding_dim"]
    blocks, T = config["num_attention_blocks"], frames
    per_frame = S * C + 2 * C * sum(TEMPORAL_KERNELS) + blocks * 12 * C * C + C * C
    attention = blocks * 2 * 2 * T * T * C
    return 2 * T * per_frame + attention + 2 * (3 * C * C + C * E)


def attention_video_flops(config: dict, frames: int) -> int:
    return frames * frame_flops(config) + head_flops(config, frames)


def spatial_encoder_weight_bytes(config: dict) -> int:
    params = sum(cout * cin * k * k + cout for cin, cout, k, _ in SPATIAL)
    params += SPATIAL[-1][1] * config["spatial_dim"] + config["spatial_dim"]
    return params * element_bytes(config)


def _cnn3d_layers(config: dict, frames: int) -> Tuple[List[int], int, int]:
    """(multiply-adds of each Conv3d block, remaining time steps, remaining
    height) of one window of `frames` frames, padded by the model to a
    multiple of its stride."""
    s, size = config["frame_stride"], config["frame_size"]
    t = -(-frames // s)
    h = _out(size, 5, 2, 2)
    macs = [t * h * h * CNN3D_CHANNELS[1] * CNN3D_CHANNELS[0] * s * 25]
    for i, t_stride in ((1, 1), (2, 2), (3, 1)):
        t, h = _out(t, 3, t_stride, 1), _out(h, 3, 2, 1)
        macs.append(t * h * h * CNN3D_CHANNELS[i + 1] * CNN3D_CHANNELS[i] * 27)
    return macs, t, h


def cnn3d_encoder_flops(config: dict, frames: int) -> int:
    return 2 * sum(_cnn3d_layers(config, frames)[0])


def cnn3d_window_flops(config: dict, frames: int) -> int:
    """The 3D model on one window: the encoder, the temporal conv and
    attention logits, the projector."""
    macs, t, _ = _cnn3d_layers(config, frames)
    C, E = CNN3D_CHANNELS[-1], config["embedding_dim"]
    return 2 * (sum(macs) + t * (C * C * 3 + C) + C * C + C * E)


def cnn3d_encoder_out_bytes(config: dict, frames: int) -> int:
    """The encoder's output for one window: (128, t, h, h) in the compute dtype."""
    _, t, h = _cnn3d_layers(config, frames)
    return CNN3D_CHANNELS[-1] * t * h * h * element_bytes(config)


def cnn3d_encoder_weight_bytes(config: dict) -> int:
    s = config["frame_stride"]
    kernels = (s * 25, 27, 27, 27)
    params = sum(CNN3D_CHANNELS[i + 1] * CNN3D_CHANNELS[i] * kernels[i] + CNN3D_CHANNELS[i + 1]
                 for i in range(4))
    return params * element_bytes(config)


def frame_bytes(config: dict) -> int:
    """One uint8 frame as the scan stages it."""
    return config["frame_size"] ** 2 * 3


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at HBM bandwidth."""
    return max(flops / BF16_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
