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


def capture_graph(fn, calls: int) -> torch.cuda.CUDAGraph:
    """One CUDA graph holding `calls` calls of fn(), after one warm-up call
    off the capture (on a side stream, as CUDA graphs need). fn must not
    synchronise."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn, calls: int = 10, window_ms: float = 100.0) -> float:
    """Device time of fn() with the host's cost per call taken out: `calls`
    calls captured in one CUDA graph, replayed back to back (cuda_ms), per
    call. Where a call lasts less than its Python overhead, cuda_ms measures
    the host; this measures the card. fn must not synchronise."""
    return cuda_ms(capture_graph(fn, calls).replay, window_ms) / calls


def replay_ms(graph: torch.cuda.CUDAGraph, calls: int, timings: int = 3) -> list[float]:
    """Device ms per call of a graph holding `calls` calls: one warm replay,
    then `timings` replays, each timed alone by CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    return [_elapsed_ms(graph.replay, 1) / calls for _ in range(timings)]
