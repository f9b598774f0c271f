"""Contrastive and triplet losses over embeddings, as plain tensor functions
under autograd.

Port of video_fingerprint_tpu/ops/losses.py, the same vectorized forms (the
reference's per-anchor loop, model.py:37-64, as masked matrix ops) and the
same values: batch-hard triplet with the mean over strictly positive
anchors, symmetric InfoNCE, the attention model's normalised combination
and the 3D model's hard-negative term.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def pairwise_l2(embeddings: torch.Tensor) -> torch.Tensor:
    """All-pairs Euclidean distances, (B, D) -> (B, B). The sqrt is guarded
    (+1e-12) for autograd at zero distance (an extract equal to its video)."""
    sq = torch.sum(embeddings * embeddings, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (embeddings @ embeddings.T)
    return torch.sqrt(torch.clamp(d2, min=0.0) + 1e-12)


def triplet_loss(embeddings: torch.Tensor, video_ids: torch.Tensor,
                 margin: float = 0.3) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch-hard triplet loss (reference model.py:8-71, vectorized): per
    anchor the hardest positive and the hardest negative, relu(hp - hn +
    margin), averaged over the anchors whose loss is strictly positive.

    Returns (loss, num_valid_triplets)."""
    distances = pairwise_l2(embeddings)
    same = video_ids[:, None] == video_ids[None, :]
    eye = torch.eye(embeddings.shape[0], dtype=torch.bool, device=embeddings.device)
    pos_mask = same & ~eye
    neg_mask = ~same & ~eye
    has_pos = pos_mask.any(dim=1)
    has_neg = neg_mask.any(dim=1)

    big = torch.finfo(distances.dtype).max
    hardest_pos = torch.where(pos_mask, distances, -big).amax(dim=1)
    hardest_neg = torch.where(neg_mask, distances, big).amin(dim=1)

    per_anchor = torch.clamp(hardest_pos - hardest_neg + margin, min=0.0)
    per_anchor = torch.where(has_pos & has_neg, per_anchor, 0.0)
    num_valid = (per_anchor > 0).sum()
    loss = torch.where(num_valid > 0,
                       per_anchor.sum() / torch.clamp(num_valid, min=1), 0.0)
    return loss, num_valid


def _ce_diag(logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy with labels arange(B) (diagonal positives)."""
    return torch.mean(torch.logsumexp(logits, dim=1) - torch.diagonal(logits))


def infonce_symmetric(emb_a: torch.Tensor, emb_b: torch.Tensor,
                      temperature: torch.Tensor) -> torch.Tensor:
    """CE(A Bᵀ/τ) + CE((A Bᵀ/τ)ᵀ) (reference model.py:343-347)."""
    logits = (emb_a @ emb_b.T) / temperature
    return _ce_diag(logits) + _ce_diag(logits.T)


def attention_contrastive_loss(
    emb_full_1: torch.Tensor,
    emb_full_2: torch.Tensor,
    emb_extract_1: torch.Tensor,
    emb_extract_2: torch.Tensor,
    temperature: torch.Tensor,
    video_ids: Optional[torch.Tensor] = None,
    use_triplet: bool = True,
    triplet_weight: float = 0.3,
    triplet_margin: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """The attention model's loss over precomputed embeddings
    (reference model.py:300-390), normalised by 3.6 + triplet_weight."""
    loss_full = infonce_symmetric(emb_full_1, emb_full_2, temperature)
    # extract terms: one-directional CE each (model.py:349-353)
    loss_extract = (_ce_diag((emb_extract_1 @ emb_full_1.T) / temperature)
                    + _ce_diag((emb_extract_2 @ emb_full_2.T) / temperature))
    loss_extract_cross = infonce_symmetric(emb_extract_1, emb_extract_2, temperature)
    total = loss_full + 0.5 * loss_extract + 0.3 * loss_extract_cross

    device = emb_full_1.device
    t_loss = torch.zeros((), device=device)
    n_triplets = torch.zeros((), dtype=torch.int64, device=device)
    if use_triplet and video_ids is not None:
        all_emb = torch.cat([emb_full_1, emb_full_2, emb_extract_1, emb_extract_2], dim=0)
        all_ids = torch.cat([video_ids] * 4, dim=0)
        t_loss, n_triplets = triplet_loss(all_emb, all_ids, margin=triplet_margin)
        total = total + triplet_weight * t_loss

    return {
        "loss": total / (3.6 + triplet_weight),
        "loss_full": loss_full / 2,
        "loss_extract": loss_extract / 2,
        "loss_extract_cross": loss_extract_cross / 2,
        "loss_triplet": t_loss,
        "num_triplets": n_triplets,
        "temperature": temperature,
    }


def cnn3d_contrastive_loss(
    emb1: torch.Tensor,
    emb2: torch.Tensor,
    temperature: torch.Tensor,
    video_ids: Optional[torch.Tensor] = None,
    hard_negative_ratio: float = 0.3,
    use_triplet: bool = True,
    triplet_weight: float = 0.3,
    triplet_margin: float = 0.3,
) -> Dict[str, torch.Tensor]:
    """The 3D model's loss: symmetric InfoNCE + hard-negative CE
    (reference model.py:514-582). The hard negatives are picked by
    `torch.topk` on detached logits (no gradient through the pick, as the
    reference mines under no_grad); the loss depends only on the picked
    values, so the order of tied picks does not matter."""
    B = emb1.shape[0]
    logits = (emb1 @ emb2.T) / temperature
    loss_12 = _ce_diag(logits)
    loss_21 = _ce_diag(logits.T)

    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    neg_logits = logits.detach().masked_fill(eye, float("-inf"))
    k = max(1, int(B * hard_negative_ratio))
    hard_idx = torch.topk(neg_logits, k, dim=1).indices

    hard_logits = torch.gather(logits, 1, hard_idx)
    hard_all = torch.cat([torch.diagonal(logits)[:, None], hard_logits], dim=1)
    hard_loss = torch.mean(torch.logsumexp(hard_all, dim=1) - hard_all[:, 0])

    total = (loss_12 + loss_21) / 2 + 0.5 * hard_loss

    t_loss = torch.zeros((), device=logits.device)
    n_triplets = torch.zeros((), dtype=torch.int64, device=logits.device)
    if use_triplet and video_ids is not None:
        all_emb = torch.cat([emb1, emb2], dim=0)
        all_ids = torch.cat([video_ids, video_ids], dim=0)
        t_loss, n_triplets = triplet_loss(all_emb, all_ids, margin=triplet_margin)
        total = total + triplet_weight * t_loss

    return {
        "loss": total,
        "loss_standard": (loss_12 + loss_21) / 2,
        "loss_hard": hard_loss,
        "loss_triplet": t_loss,
        "num_triplets": n_triplets,
        "temperature": temperature,
    }
