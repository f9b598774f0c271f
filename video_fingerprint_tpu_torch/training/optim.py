"""Optimizer construction: the JAX package's optax recipe in torch.

Port of video_fingerprint_tpu/training/optim.py (reference train.py:33-79):

- a global grad-norm clip at 1.0 before AdamW, with optax's formula: the
  grads are scaled by max_norm / norm when norm >= max_norm
  (`torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6 instead);
- AdamW, betas (0.9, 0.999), eps 1e-8, weight decay 1e-4 on every
  parameter (decoupled, as optax.adamw applies it);
- attention model: three parameter groups split by top-level module name,
  spatial_encoder x0.1, attention_blocks x0.5, the rest x1 (temperature
  included), each on the batch-stepped warmup cosine floored at 0.1;
- 3D model: one group on the epoch-stepped cosine annealing to lr * 0.01.

Schedules are step -> LR factor. optax takes the schedule at the update
count before the increment, so the first update runs at factor
schedule(0), which is 0 during warmup: `set_learning_rates(opt, step)` is
called before every `opt.step()` with the number of updates done so far.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List

import torch

GROUP_FACTORS = {"spatial": 0.1, "attention": 0.5, "other": 1.0}


def warmup_cosine_floor(total_steps: int, floor: float = 0.1) -> Callable[[int], float]:
    """Reference lr_lambda (train.py:71-77): linear warmup over the first
    10 % of steps, then cosine decay floored at `floor`."""
    warmup = max(1, total_steps // 10)

    def schedule(step: int) -> float:
        if step < warmup:
            return step / warmup
        progress = (step - warmup) / max(1, total_steps - warmup)
        return max(floor, 0.5 * (1.0 + math.cos(math.pi * progress)))

    return schedule


def epoch_cosine_annealing(epochs: int, steps_per_epoch: int,
                           eta_min_ratio: float = 0.01) -> Callable[[int], float]:
    """torch CosineAnnealingLR stepped per epoch (train.py:61-66, :613-614)."""

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        return eta_min_ratio + (1.0 - eta_min_ratio) * 0.5 * (
            1.0 + math.cos(math.pi * min(epoch, epochs) / max(1, epochs)))

    return schedule


def param_group_label(name: str) -> str:
    """spatial / attention / other by the top-level module name (JAX
    `_attention_param_labels`); `name` is a torch parameter name
    ("attention_blocks.0...") or a flax top-level key ("attention_blocks_0")."""
    top = name.split(".")[0]
    if top.startswith("spatial_encoder"):
        return "spatial"
    if top.startswith("attention_blocks"):
        return "attention"
    return "other"


def make_optimizer(
    model_type: str,
    model: torch.nn.Module,
    learning_rate: float,
    weight_decay: float = 1e-4,
    total_steps: int = 10_000,
    epochs: int = 50,
    steps_per_epoch: int = 100,
) -> torch.optim.AdamW:
    """AdamW over `model`'s parameters. Each group carries `label`,
    `base_lr` (learning_rate times its factor) and `schedule`."""
    named = list(model.named_parameters())
    if model_type == "attention":
        schedule = warmup_cosine_floor(total_steps)
        groups: Dict[str, List] = {label: [] for label in GROUP_FACTORS}
        for name, p in named:
            groups[param_group_label(name)].append(p)
        param_groups = [{"params": groups[label], "label": label,
                         "base_lr": learning_rate * factor, "schedule": schedule}
                        for label, factor in GROUP_FACTORS.items()]
    else:
        param_groups = [{"params": [p for _, p in named], "label": "all",
                         "base_lr": learning_rate,
                         "schedule": epoch_cosine_annealing(epochs, steps_per_epoch)}]
    opt = torch.optim.AdamW(param_groups, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    set_learning_rates(opt, 0)
    return opt


def set_learning_rates(opt: torch.optim.Optimizer, step: int) -> None:
    """Each group's LR for the update that follows `step` earlier ones."""
    for group in opt.param_groups:
        group["lr"] = group["base_lr"] * group["schedule"](step)


@torch.no_grad()
def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: when the global norm is at least
    max_norm, every grad is scaled by max_norm / norm. Returns the norm of
    the grads as they came (the train step's `grad_norm`), with no host
    sync."""
    grads = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm >= max_norm, max_norm / norm, 1.0)
    torch._foreach_mul_(grads, scale)
    return norm


def current_lr(model_type: str, learning_rate: float, step: int,
               total_steps: int, epochs: int, steps_per_epoch: int) -> float:
    """The schedule's LR at `step`, for logging (train.py:256-258)."""
    if model_type == "attention":
        return learning_rate * warmup_cosine_floor(total_steps)(step)
    return learning_rate * epoch_cosine_annealing(epochs, steps_per_epoch)(step)
