"""The train and eval steps: loss, grads, the clipped AdamW update, metrics.

Port of video_fingerprint_tpu/training/train_step.py (reference
train.py:140-284, model.py:300-390). As there, the 2B random extracts of a
batch are one vectorized gather with a per-frame mask, and full1/full2 and
ex1/ex2 run as two (2B, T) forwards; accuracy reuses the loss path's
embeddings.

Clips stay uint8 through the extract gather: the models divide uint8 input
by 255 in their compute dtype, the JAX step's `normalize_clip`, so the
copies to the card and the gathers move 4x fewer bytes.

Drawing is split from applying. `draw_extracts` draws the per-sample
extract lengths and the uniform start variates from an explicit
torch.Generator; `sample_extracts` and the loss take those draws as
arguments, so a test can feed in the JAX package's draws. Dropout draws
come from torch's own generator.

Masking policy (as in the JAX package): with `mask_padding` (default)
zero-padded frames are kept out of the convs' receptive fields, the
attention keys and the pooling.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from video_fingerprint_tpu_torch.ops.losses import (
    attention_contrastive_loss,
    cnn3d_contrastive_loss,
)
from video_fingerprint_tpu_torch.training.optim import clip_by_global_norm, set_learning_rates
from video_fingerprint_tpu_torch.utils.precision import full_fp32

Batch = Dict[str, torch.Tensor]


def sample_extract_lengths(generator: torch.Generator, B: int, T: int,
                           extract_ratio: float) -> torch.Tensor:
    """One extract length per sample in [int(T * ratio), T], shared by both
    extracts of the pair (reference model.py:326)."""
    return torch.randint(int(T * extract_ratio), T + 1, (B,), generator=generator)


def draw_extracts(generator: torch.Generator, B: int, T: int,
                  extract_ratio: float) -> Dict[str, torch.Tensor]:
    """The random draws of one step's extracts, on the CPU: shared lengths
    and one uniform start variate per sample and side."""
    lengths = sample_extract_lengths(generator, B, T, extract_ratio)
    u1 = torch.rand((B,), generator=generator)
    u2 = torch.rand((B,), generator=generator)
    return {"lengths": lengths, "u1": u1, "u2": u2}


def sample_extracts(video: torch.Tensor, lengths: torch.Tensor, u: torch.Tensor,
                    true_lengths: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extracts of `lengths` frames from start floor(u * (max_start + 1)),
    with max_start = T - length clamped to true_length - 1 when the real
    frame counts are known, so every extract overlaps a real frame (JAX
    train_step.py:78-107).

    Returns (extract (B, T, ...) gathered from start, mask (B, T), idx (B, T)).
    """
    B, T = video.shape[0], video.shape[1]
    device = video.device
    lengths = lengths.to(device)
    max_start = T - lengths
    if true_lengths is not None:
        max_start = torch.minimum(max_start, torch.clamp(true_lengths.to(device) - 1, min=0))
    starts = torch.floor(u.to(device) * (max_start + 1).to(torch.float32)).to(torch.int64)
    pos = torch.arange(T, device=device)[None, :]
    idx = torch.clamp(starts[:, None] + pos, max=T - 1)
    extract = video[torch.arange(B, device=device)[:, None], idx]
    mask = pos < lengths[:, None]
    return extract, mask, idx


def _extract_masks(draws, clip1, clip2, m1, m2):
    """Both sides' extracts: the pixels, the (2B, T) extract mask ANDed with
    the source frames' mask, and the (2B, T) source indices."""
    lengths = draws["lengths"]
    tl1 = m1.sum(dim=1) if m1 is not None else None
    tl2 = m2.sum(dim=1) if m2 is not None else None
    ex1, exm1, idx1 = sample_extracts(clip1, lengths, draws["u1"], tl1)
    ex2, exm2, idx2 = sample_extracts(clip2, lengths, draws["u2"], tl2)
    # extracted frame j came from source index idx[j]: valid only if that
    # was a real frame
    if m1 is not None:
        exm1 = exm1 & torch.gather(m1, 1, idx1)
    if m2 is not None:
        exm2 = exm2 & torch.gather(m2, 1, idx2)
    return (torch.cat([ex1, ex2]), torch.cat([exm1, exm2]),
            torch.cat([idx1, idx2]))


def _gather_rows(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feats (B, T, C) rows at idx (B, T)."""
    return torch.gather(feats, 1, idx[:, :, None].expand(-1, -1, feats.shape[2]))


def _accuracy(emb1, emb2, temperature) -> torch.Tensor:
    with torch.no_grad():
        logits = (emb1 @ emb2.T) / temperature
        target = torch.arange(emb1.shape[0], device=emb1.device)
        return (logits.argmax(dim=1) == target).to(torch.float32).mean()


@contextlib.contextmanager
def _running_stats_frozen(model: torch.nn.Module):
    """BatchNorm momentum 0 inside the block: a forward recomputed for the
    backward (remat) must not update the running statistics a second time."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 0.0
    try:
        yield
    finally:
        for m, momentum in zip(bns, saved):
            m.momentum = momentum


def compute_context(device: torch.device, bf16: bool):
    """bf16 compute with f32 parameters (autocast), or f32 with TF32 off."""
    if bf16:
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return full_fp32()


def make_loss_fn(
    model: torch.nn.Module,
    model_type: str,
    triplet_weight: float = 0.3,
    triplet_margin: float = 0.3,
    use_triplet: bool = True,
    mask_padding: bool = True,
    remat: bool = False,
    device_augment: bool = False,
    reuse_extract_features: bool = False,
) -> Callable[[Batch, Optional[Dict[str, torch.Tensor]]], Tuple[torch.Tensor, Dict]]:
    """The train-mode loss: (batch, draws) -> (loss, metrics). The model must
    be in train mode; BatchNorm running statistics update in place.

    batch: {'clip1', 'clip2': (B, T, H, W, C) uint8 or float, 'video_id':
    (B,), 'mask1', 'mask2': (B, T) bool (optional)}; draws: `draw_extracts`'s
    output (attention), None for the 3D model.

    remat=True recomputes each forward's activations in the backward
    (torch.utils.checkpoint per forward, as jax.checkpoint in JAX), with the
    BatchNorm running statistics updated once.

    reuse_extract_features=True (attention) encodes every frame once and
    embeds the extracts from gathered rows of the (2B, T, spatial_dim)
    feature map (JAX train_step.py:142-156): the extract frames are then
    normalized with the full batch's BN statistics, and the encoder's
    running statistics see one update per step instead of two.
    """
    if device_augment:
        raise NotImplementedError("device_augment is not ported yet (ROADMAP item 11)")

    def remat_fn(fn):
        if not remat:
            return fn
        return lambda *args: checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), _running_stats_frozen(model)))

    fwd = remat_fn(lambda x, mask: model(x, mask))
    enc = remat_fn(lambda x: model.encode_frames(x))
    head = remat_fn(lambda feats, mask: model.forward_from_features(feats, mask))
    fwd_3d = remat_fn(lambda x: model(x))

    def loss_fn(batch: Batch, draws=None):
        clip1, clip2 = batch["clip1"], batch["clip2"]
        B = clip1.shape[0]
        video_ids = batch.get("video_id") if use_triplet else None
        temperature = model.temperature
        if model_type == "attention":
            m1 = batch.get("mask1") if mask_padding else None
            m2 = batch.get("mask2") if mask_padding else None
            exs, exmask, idxcat = _extract_masks(draws, clip1, clip2, m1, m2)
            fulls = torch.cat([clip1, clip2])
            fmask = torch.cat([m1, m2]) if m1 is not None and m2 is not None else None
            if reuse_extract_features:
                feats_full = enc(fulls)
                emb_full = head(feats_full, fmask)
                emb_ex = head(_gather_rows(feats_full, idxcat), exmask)
            else:
                emb_full = fwd(fulls, fmask)
                emb_ex = fwd(exs, exmask)
            out = attention_contrastive_loss(
                emb_full[:B], emb_full[B:], emb_ex[:B], emb_ex[B:],
                temperature=temperature, video_ids=video_ids, use_triplet=use_triplet,
                triplet_weight=triplet_weight, triplet_margin=triplet_margin)
            emb1, emb2 = emb_full[:B], emb_full[B:]
        else:
            emb = fwd_3d(torch.cat([clip1, clip2]))
            emb1, emb2 = emb[:B], emb[B:]
            out = cnn3d_contrastive_loss(
                emb1, emb2, temperature=temperature, video_ids=video_ids,
                use_triplet=use_triplet, triplet_weight=triplet_weight,
                triplet_margin=triplet_margin)
        # accuracy from the loss path's embeddings (the reference pays two
        # more no-grad forwards for it, train.py:235-241)
        out["acc"] = _accuracy(emb1, emb2, temperature)
        return out["loss"], out

    return loss_fn


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    model_type: str,
    grad_clip: float = 1.0,
    bf16: bool = False,
    debug_nans: bool = False,
    **loss_kwargs,
) -> Callable[[Batch, Optional[Dict[str, torch.Tensor]], int], Dict[str, torch.Tensor]]:
    """The train step: (batch, draws, step) -> metrics, where `step` is the
    number of updates done before (the schedules' position). Loss and grads
    in train mode, the global-norm clip, the LRs at `step`, one AdamW update.
    metrics['grad_norm'] is the norm of the unclipped grads. Nothing is read
    back to the host unless `debug_nans`, which raises on the first
    non-finite loss or grad."""
    loss_fn = make_loss_fn(model, model_type, **loss_kwargs)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(batch: Batch, draws, step: int) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with compute_context(batch["clip1"].device, bf16):
            loss, out = loss_fn(batch, draws)
        with full_fp32():  # the backward outside autocast, TF32 off
            loss.backward()
        grad_norm = clip_by_global_norm([p.grad for p in params], grad_clip)
        if debug_nans and not bool(torch.isfinite(loss) & torch.isfinite(grad_norm)):
            raise FloatingPointError(f"non-finite loss {loss.item()} or grad norm "
                                     f"{grad_norm.item()} at step {step}")
        set_learning_rates(optimizer, step)
        optimizer.step()
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_eval_step(model: torch.nn.Module, model_type: str, mask_padding: bool = True,
                   reuse_extract_features: bool = True, bf16: bool = False
                   ) -> Callable[[Batch, Optional[Dict[str, torch.Tensor]]], Tuple]:
    """Validation step: (batch, draws) -> (metrics, emb1, emb2), one forward
    pair in eval mode (the attention kernel on the card), loss without the
    triplet term (the reference's validate passes no video ids), accuracy.
    The draws come from `draw_extracts` with ratio 0.5: the reference's
    validate never threads its min_extract_ratio (JAX train_step.py:381-386).

    reuse_extract_features (default on) embeds the extracts from gathered
    rows of the full forward's per-frame features, which is exact in eval
    mode (running BN statistics, no dropout)."""

    @torch.no_grad()
    def eval_step(batch: Batch, draws=None):
        model.eval()
        clip1, clip2 = batch["clip1"], batch["clip2"]
        B = clip1.shape[0]
        fulls = torch.cat([clip1, clip2])
        with compute_context(clip1.device, bf16):
            if model_type == "attention":
                m1 = batch.get("mask1") if mask_padding else None
                m2 = batch.get("mask2") if mask_padding else None
                fmask = torch.cat([m1, m2]) if m1 is not None and m2 is not None else None
                exs, exmask, idxcat = _extract_masks(draws, clip1, clip2, m1, m2)
                if reuse_extract_features:
                    feats_full = model.encode_frames(fulls)
                    emb = model.forward_from_features(feats_full, fmask)
                    emb_ex = model.forward_from_features(_gather_rows(feats_full, idxcat),
                                                         exmask)
                else:
                    emb = model(fulls, fmask)
                    emb_ex = model(exs, exmask)
                emb1, emb2 = emb[:B], emb[B:]
                out = attention_contrastive_loss(emb1, emb2, emb_ex[:B], emb_ex[B:],
                                                 temperature=model.temperature)
            else:
                emb = model(fulls)
                emb1, emb2 = emb[:B], emb[B:]
                out = cnn3d_contrastive_loss(emb1, emb2, temperature=model.temperature)
            out["acc"] = _accuracy(emb1, emb2, model.temperature)
        return out, emb1, emb2

    return eval_step
