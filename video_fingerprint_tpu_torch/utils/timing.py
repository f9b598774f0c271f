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


def loop_ms(step, k: int, reps: int, device: torch.device, weight: float = 1.0) -> float:
    """Median ms per iteration of a loop of k iterations, iteration i adding
    weight * the f32 sum of step(i, acc) to the scalar acc, so that no
    iteration can be skipped (the JAX tools' in-graph `fori_loop` with a
    scalar accumulator). On a card: the k iterations captured in one CUDA
    graph, replayed once untimed and then `reps` times, each replay timed by
    CUDA events (device time). On the CPU: the loop run eagerly once untimed
    and then `reps` times by the host clock (not a device time). Raises on a
    non-finite sum."""
    import statistics
    import time

    acc = torch.zeros((), dtype=torch.float32, device=device)

    def run():
        for i in range(k):
            acc.add_(step(i, acc).sum(dtype=torch.float32), alpha=weight)

    if torch.device(device).type == "cuda":
        times = replay_ms(capture_graph(run, 1), k, timings=reps)
    else:
        run()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3 / k)
    if not bool(torch.isfinite(acc)):
        raise FloatingPointError(f"non-finite sum {acc}")
    return statistics.median(times)
