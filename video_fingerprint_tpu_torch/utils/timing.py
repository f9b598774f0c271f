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


def graph_ms(fn, calls: int = 10, window_ms: float = 100.0) -> float:
    """Device time of fn() with the host's cost per call taken out: `calls`
    calls captured in one CUDA graph, replayed back to back (cuda_ms), per
    call. Where a call lasts less than its Python overhead, cuda_ms measures
    the host; this measures the card. fn must not synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as CUDA graphs need
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, window_ms) / calls
