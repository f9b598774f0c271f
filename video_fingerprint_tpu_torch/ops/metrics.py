"""Validation metrics: discrimination, AUC-ROC, retrieval (R@k, mAP).

Port of video_fingerprint_tpu/ops/metrics.py (reference train.py:286-481),
the same definitions:

  - intra/inter similarity mean and std, separation gap, precision /
    recall / F1 / FPR at thresholds, over ordered pairs i != j;
  - AUC-ROC as the exact tie-corrected Mann-Whitney statistic
    (sklearn.roc_auc_score's value): P(intra > inter) + P(tie) / 2;
  - R@k (a same-id video among the k most similar, self excluded) and the
    reference's mAP, where self is masked to -inf but still counts as a
    positive at the last rank.

Similarities are f32 products with TF32 off; counts and sums are kept in
int64 / float64. Rankings use a stable descending sort, as jnp.argsort
and lax.top_k order ties (the lower index first).

`streaming_validation_metrics` computes the same metrics block by block in
O(block_rows * N) device memory (256-row blocks of the N x N similarity
matrix), summing the blocks' counts in float64 on the host.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from video_fingerprint_tpu_torch.utils.precision import full_fp32

THRESHOLDS = (0.7, 0.8, 0.85, 0.9)
K_VALUES = (1, 5, 10)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _sims(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return rows.to(torch.float32) @ cols.to(torch.float32).T


def weighted_auc(scores: torch.Tensor, w_pos: torch.Tensor,
                 w_neg: torch.Tensor) -> torch.Tensor:
    """AUC = P(pos > neg) + 0.5 P(pos == neg) over weighted samples (M,)."""
    s_sorted, order = torch.sort(scores, stable=True)
    w_neg = w_neg.to(torch.float64)
    cum_neg = torch.cat([torch.zeros(1, dtype=torch.float64, device=scores.device),
                         torch.cumsum(w_neg[order], 0)])
    lo = torch.searchsorted(s_sorted, scores, right=False)
    hi = torch.searchsorted(s_sorted, scores, right=True)
    neg_below = cum_neg[lo]
    neg_equal = cum_neg[hi] - cum_neg[lo]
    w_pos = w_pos.to(torch.float64)
    n_pos, n_neg = w_pos.sum(), w_neg.sum()
    num = torch.sum(w_pos * (neg_below + 0.5 * neg_equal))
    if n_pos > 0 and n_neg > 0:
        return num / (n_pos * n_neg)
    return torch.tensor(0.5, dtype=torch.float64)


def _rates(tp, fp, fn, tn) -> Dict[str, float]:
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    fpr = fp / (fp + tn) if fp + tn > 0 else 0.0
    return {"precision": precision, "recall": recall, "f1": f1, "fpr": fpr}


def _discrimination(acc: Dict[str, float], thresholds) -> Dict[str, float]:
    """Metrics from the summed pair statistics (shared by both paths)."""
    n_intra, n_inter = acc["n_intra"], acc["n_inter"]

    def mean_std(total, total_sq, cnt):
        if cnt <= 0:
            return 0.0, 0.0
        mean = total / cnt
        return mean, max(total_sq / cnt - mean * mean, 0.0) ** 0.5

    intra_mean, intra_std = mean_std(acc["intra_sum"], acc["intra_sumsq"], n_intra)
    inter_mean, inter_std = mean_std(acc["inter_sum"], acc["inter_sumsq"], n_inter)
    metrics = {
        "intra_sim_mean": intra_mean, "intra_sim_std": intra_std,
        "inter_sim_mean": inter_mean, "inter_sim_std": inter_std,
        "separation_gap": intra_mean - inter_mean if n_intra > 0 and n_inter > 0 else 0.0,
    }
    for t in thresholds:
        r = _rates(acc[f"tp@{t}"], acc[f"fp@{t}"], acc[f"fn@{t}"], acc[f"tn@{t}"])
        for name in ("precision", "recall", "f1", "fpr"):
            metrics[f"{name}@{t:.2f}"] = r[name]
    return metrics


def _pair_stats(sims, intra, inter, thresholds) -> Dict[str, torch.Tensor]:
    """Counts and sums (float64) of one block of ordered pairs."""
    s = sims.to(torch.float64)
    out = {"n_intra": intra.sum(), "n_inter": inter.sum(),
           "intra_sum": (s * intra).sum(), "intra_sumsq": (s * s * intra).sum(),
           "inter_sum": (s * inter).sum(), "inter_sumsq": (s * s * inter).sum()}
    for t in thresholds:
        hit = sims >= t
        out[f"tp@{t}"] = (hit & intra).sum()
        out[f"fp@{t}"] = (hit & inter).sum()
        out[f"fn@{t}"] = (~hit & intra).sum()
        out[f"tn@{t}"] = (~hit & inter).sum()
    return out


def _ranking_stats(sims, same, eye, kmax: int) -> Dict[str, torch.Tensor]:
    """R@k hit counts (k = 1..kmax) and the mAP sum of full rows: self at
    -inf still counts as a positive (reference train.py:466-479)."""
    sims_noself = sims.masked_fill(eye, float("-inf"))
    order = torch.sort(sims_noself, dim=1, descending=True, stable=True).indices
    pos_sorted = torch.gather(same, 1, order)
    top_same = pos_sorted[:, :kmax] & ~torch.gather(eye, 1, order[:, :kmax])
    hits = torch.cumsum(top_same.to(torch.int64), dim=1) > 0
    out = {f"rhits@{k}": hits[:, k - 1].sum() for k in range(1, kmax + 1)}
    out["rhits@0"] = torch.zeros((), dtype=torch.int64, device=sims.device)  # one video
    pos = pos_sorted.to(torch.float64)
    ranks = torch.arange(1, sims.shape[1] + 1, dtype=torch.float64, device=sims.device)
    ap = (torch.cumsum(pos, dim=1) / ranks * pos).sum(dim=1) / pos.sum(dim=1).clamp_min(1.0)
    out["ap_sum"] = ap.sum()
    return out


def discrimination_metrics(embeddings, video_ids,
                           thresholds: Sequence[float] = THRESHOLDS) -> Dict[str, float]:
    """Dense discrimination metrics and AUC-ROC over the N x N similarities."""
    e = _as_tensor(embeddings)
    ids = _as_tensor(video_ids).to(e.device)
    sims = _sims(e, e)
    n = e.shape[0]
    same = ids[:, None] == ids[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=e.device)
    intra, inter = same & ~eye, ~same & ~eye
    acc = {k: float(v) for k, v in _pair_stats(sims, intra, inter, thresholds).items()}
    metrics = _discrimination(acc, thresholds)
    metrics["auc_roc"] = float(weighted_auc(sims.reshape(-1), intra.reshape(-1),
                                            inter.reshape(-1)))
    return metrics


def retrieval_metrics(embeddings, video_ids,
                      k_values: Sequence[int] = K_VALUES) -> Dict[str, float]:
    """R@k and mAP over all rows (train.py:439-481). R@k for k past
    n_videos - 1 is still computed; the trainer drops those keys."""
    e = _as_tensor(embeddings)
    ids = _as_tensor(video_ids).to(e.device)
    n = e.shape[0]
    kmax = min(max(k_values), n - 1)
    same = ids[:, None] == ids[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=e.device)
    r = _ranking_stats(_sims(e, e), same, eye, kmax)
    metrics = {f"R@{k}": float(r[f"rhits@{min(k, kmax)}"]) / n for k in k_values}
    metrics["mAP"] = float(r["ap_sum"]) / n
    return metrics


def _blocks(e: torch.Tensor, ids: torch.Tensor, block_rows: int):
    """(sims, same id, self) of each block of `block_rows` rows against
    every row."""
    n = e.shape[0]
    cols = torch.arange(n, device=e.device)
    for start in range(0, n, block_rows):
        rows = slice(start, min(start + block_rows, n))
        sims = _sims(e[rows], e)
        same = ids[rows, None] == ids[None, :]
        eye = cols[None, :] == (start + torch.arange(sims.shape[0], device=e.device))[:, None]
        yield sims, same, eye


def intra_values(e: torch.Tensor, ids: torch.Tensor, block_rows: int = 256) -> torch.Tensor:
    """Every ordered intra-pair similarity (i != j, same id), ascending:
    the first pass of `streaming_validation_metrics` over its blocks, from
    the products the second pass scores (the counterpart of JAX
    `_intra_pair_sims`, which computes them group by group)."""
    return torch.sort(torch.cat([sims[same & ~eye]
                                 for sims, same, eye in _blocks(e, ids, block_rows)])).values


def streaming_validation_metrics(
    embeddings,
    video_ids,
    thresholds: Sequence[float] = THRESHOLDS,
    k_values: Sequence[int] = K_VALUES,
    block_rows: int = 256,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """discrimination_metrics + retrieval_metrics in O(block_rows * N)
    device memory, exact: R@k and mAP see full rows per block, the moments
    and confusions are blocked sums, and AUC counts, for every inter
    similarity of a block, the intra similarities above and equal to it in
    the sorted intra values (collected by a first pass over the same
    blocks, so both sides come from the same products). Returns floats."""
    e = _as_tensor(embeddings)
    if device is not None:
        e = e.to(device)
    ids = _as_tensor(video_ids).to(e.device)
    n = e.shape[0]
    if n == 0:
        raise ValueError("streaming_validation_metrics needs >= 1 embedding")
    kmax = min(max(k_values), n - 1)
    intra_vals = intra_values(e, ids, block_rows)
    p = intra_vals.numel()
    per_block = []
    for sims, same, eye in _blocks(e, ids, block_rows):
        intra, inter = same & ~eye, ~same & ~eye
        out = _pair_stats(sims, intra, inter, thresholds)
        out.update(_ranking_stats(sims, same, eye, kmax))
        v = sims[inter]
        le = torch.searchsorted(intra_vals, v, right=True)
        lt = torch.searchsorted(intra_vals, v, right=False)
        out["auc_num"] = ((p - le).to(torch.float64) + 0.5 * (le - lt).to(torch.float64)).sum()
        per_block.append(torch.stack([x.to(torch.float64) for x in out.values()]))
    totals = torch.stack(per_block).cpu().numpy().astype(np.float64).sum(axis=0)
    acc = dict(zip(out.keys(), (float(x) for x in totals)))

    metrics = _discrimination(acc, thresholds)
    n_intra, n_inter = acc["n_intra"], acc["n_inter"]
    metrics["auc_roc"] = (acc["auc_num"] / (n_intra * n_inter)
                          if n_intra > 0 and n_inter > 0 else 0.5)
    for k in k_values:
        metrics[f"R@{k}"] = acc[f"rhits@{min(k, kmax)}"] / n
    metrics["mAP"] = acc["ap_sum"] / n
    return metrics
