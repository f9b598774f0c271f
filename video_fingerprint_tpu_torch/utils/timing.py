"""Device time of a call on the card, with CUDA events."""

from __future__ import annotations

import torch


def _elapsed_ms(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, window_ms: float = 100.0) -> float:
    """Mean device time of fn() (CUDA events) over back-to-back calls that
    fill at least `window_ms`, after a warm-up of a quarter of that."""
    fn()
    torch.cuda.synchronize()
    estimate = _elapsed_ms(fn, 3) / 3
    iters = max(3, min(2000, int(window_ms / max(estimate, 1e-3))))
    _elapsed_ms(fn, max(1, iters // 4))
    return _elapsed_ms(fn, iters) / iters
