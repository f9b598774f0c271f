"""Analytic operation counts of the attention model, for MFU.

The JAX benchmarks count with XLA's `cost_analysis` of a CPU lowering
(tools/bench_headline.py:72-86, tools/bench_train.py:207). The port has no
compiler to ask, so it counts from the shapes of the model's own layers:
two operations per multiply-add of every product and conv (the spatial
encoder's convs and its Linear, the temporal projection, the grouped
temporal convs, the attention projections, K1's QKᵀ and PV, the MLPs, the
pooling logits, the final projection and, in a train step, the loss's
similarity matrices). Elementwise work, normalizations, softmax and the
optimizer are not counted. This is what
`torch.utils.flop_counter.FlopCounterMode` counts on the plain (CPU) path,
where attention is matmuls; it is not XLA's count, so an MFU from it is
not comparable to a TPU MFU.
"""

from __future__ import annotations

import math

from torch import nn

from video_fingerprint_tpu_torch.models.layers import MultiHeadSelfAttention

FRAME_SIZE = 64  # the scan's frame size (height = width)


def _macs(layer: nn.Module) -> int:
    """Multiply-adds of a Linear or a conv per output position."""
    if isinstance(layer, nn.Linear):
        return layer.in_features * layer.out_features
    return layer.out_channels * layer.in_channels // layer.groups * math.prod(layer.kernel_size)


def spatial_conv_flops(model: nn.Module, frame_size: int = FRAME_SIZE) -> list[int]:
    """Operations of each spatial conv on one frame."""
    enc = model.spatial_encoder
    size = frame_size // 2 if enc.s2d else frame_size  # s2d folds 2x2 blocks first
    out = []
    for conv in (m for m in enc.encoder if isinstance(m, nn.Conv2d)):
        size = (size + 2 * conv.padding[0] - conv.kernel_size[0]) // conv.stride[0] + 1
        out.append(2 * size * size * _macs(conv))
    return out


def _encoder_linear_flops(model: nn.Module) -> int:
    return 2 * _macs(model.spatial_encoder.encoder[-1])


def frame_flops(model: nn.Module, frame_size: int = FRAME_SIZE) -> int:
    """The per-frame CNN (`encode_frames`) on one frame: the convs and the
    final Linear."""
    return sum(spatial_conv_flops(model, frame_size)) + _encoder_linear_flops(model)


def head_flops(model: nn.Module, frames: int) -> int:
    """`forward_from_features` on one video of `frames` frames: every Linear
    and conv of the temporal stack per frame (the temporal convs keep the
    length; a grouped conv's output channel reads in / groups inputs), each
    attention's in-projection per frame and its QKᵀ and PV over all heads,
    and the final projection once on the pooled features."""
    T = frames
    per_frame, attention = 0, 0
    for part in (model.temporal_projection, model.temporal_conv_blocks,
                 model.attention_blocks, model.temporal_pool):
        for m in part.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                per_frame += _macs(m)
            elif isinstance(m, MultiHeadSelfAttention):
                per_frame += m.in_proj_weight.numel()
                attention += 2 * 2 * T * T * m.out_proj.in_features
    per_video = sum(_macs(m) for m in model.final_projection if isinstance(m, nn.Linear))
    return 2 * T * per_frame + attention + 2 * per_video


def forward_flops(model: nn.Module, batch: int, frames: int,
                  frame_size: int = FRAME_SIZE) -> int:
    """The eval forward (`forward_flat`) of `batch` videos of `frames`
    frames."""
    return batch * (frames * frame_flops(model, frame_size) + head_flops(model, frames))


def _loss_flops(batch: int, dim: int, use_triplet: bool) -> tuple[int, int]:
    """(forward, backward) operations of attention_contrastive_loss and the
    step's accuracy on `batch` pairs of `dim`-d embeddings: four B x B
    similarity matrices, the triplet term's 4B x 4B distance matrix and the
    accuracy's logits (no grad); each product's backward is two products of
    its size."""
    sim = 2 * batch * batch * dim
    fwd, bwd = 4 * sim, 2 * 4 * sim
    if use_triplet:
        fwd += 16 * sim
        bwd += 2 * 16 * sim
    return fwd + sim, bwd


def _step_forward_flops(model: nn.Module, batch: int, frames: int, frame_size: int,
                        fast_extracts: bool) -> int:
    """The full and the extract forwards of a train step, each over 2·batch
    clips of `frames` frames (with `fast_extracts` the per-frame CNN runs
    once and the head twice)."""
    clips = 2 * batch
    encoders = 1 if fast_extracts else 2
    return (encoders * clips * frames * frame_flops(model, frame_size)
            + 2 * clips * head_flops(model, frames))


def loss_flops(model: nn.Module, batch: int, frames: int,
               frame_size: int = FRAME_SIZE, fast_extracts: bool = False,
               use_triplet: bool = True) -> int:
    """The train-mode loss alone (training/train_step.py::make_loss_fn, no
    backward): both forwards, the loss's products and the accuracy's."""
    dim = model.final_projection[-1].out_features
    return (_step_forward_flops(model, batch, frames, frame_size, fast_extracts)
            + _loss_flops(batch, dim, use_triplet)[0])


def train_step_flops(model: nn.Module, batch: int, frames: int,
                     frame_size: int = FRAME_SIZE, remat: bool = False,
                     fast_extracts: bool = False, use_triplet: bool = True) -> int:
    """One attention train step (training/train_step.py) on `batch` clip
    pairs padded to `frames`: the full and the extract forwards, each over
    2·batch clips of `frames` frames (with `fast_extracts` the per-frame
    CNN runs once and the head twice), the loss, and the backward: two
    products per product, but no input grad for the first conv (its input
    is the pixels). remat recomputes the checkpointed forwards once more in
    the backward, up to the last op whose output the backward needs
    (torch.utils.checkpoint stops early there): with `fast_extracts` the
    encoder's final Linear is not recomputed.

    FlopCounterMode counts a grouped conv's weight grad as if the conv were
    dense (8x the temporal convs' products at the default widths); this
    count does not."""
    clips = 2 * batch
    conv0 = clips * frames * spatial_conv_flops(model, frame_size)[0]
    encoders = 1 if fast_extracts else 2
    model_fwd = _step_forward_flops(model, batch, frames, frame_size, fast_extracts)
    model_bwd = 2 * model_fwd - encoders * conv0
    dim = model.final_projection[-1].out_features
    loss_fwd, loss_bwd = _loss_flops(batch, dim, use_triplet)
    recompute = 0
    if remat:
        recompute = model_fwd
        if fast_extracts:
            recompute -= clips * frames * _encoder_linear_flops(model)
    return model_fwd + recompute + model_bwd + loss_fwd + loss_bwd
