"""The reading of the device trace, on synthetic timelines."""

from __future__ import annotations

import gzip
import json

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.trace import DeviceOp, Trace


def test_benchmark_union_counts_overlap_once():
    assert tr.union_seconds([(0, 10), (5, 15), (20, 30)]) == pytest.approx(25e-6)
    assert tr.union_seconds([]) == 0.0


def test_benchmark_idle_share_on_a_synthetic_timeline():
    # a 100 us window: kernels busy 0-20 and 30-50 (one overlapping 40-45),
    # a copy at 60-90 that counts as idle
    ops = [DeviceOp("a", "kernel", 0, 20), DeviceOp("b", "kernel", 30, 50),
           DeviceOp("c", "kernel", 40, 45), DeviceOp("copy", "memcpy", 60, 90)]
    t = Trace(start=0, end=100, ops=ops)
    assert tr.kernel_idle_percent(t) == pytest.approx(60.0)
    assert tr.busy_seconds(t.ops) == pytest.approx(70e-6)
    assert tr.idle_gaps(t, t.kernels()) == [(20, 30), (50, 100)]
    assert tr.kernel_idle_percent(Trace(start=0, end=100, ops=[ops[-1]])) is None


def test_benchmark_open_ranges_nest():
    ranges = [("bench.scan", 0, 100), ("bench.embed_clips", 10, 50),
              ("bench.spatial_encoder", 20, 30), ("bench.find_duplicates", 60, 90)]
    got = tr.open_ranges(ranges, [5, 25, 40, 70, 95, 200])
    assert got == [("bench.scan",), ("bench.scan", "bench.embed_clips", "bench.spatial_encoder"),
                   ("bench.scan", "bench.embed_clips"), ("bench.scan", "bench.find_duplicates"),
                   ("bench.scan",), ()]


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1,
            "args": args}


def test_benchmark_chrome_trace_attribution(tmp_path):
    """Kernels join their launch by correlation id, take the host ranges open
    at the launch, and only those inside the window count."""
    events = [
        _event("user_annotation", "bench.window", 100, 1000),
        _event("user_annotation", "bench.spatial_encoder", 200, 100),
        _event("user_annotation", "other.range", 200, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=1),
        _event("kernel", "conv", 230, 50, correlation=1),
        _event("cuda_driver", "cuLaunchKernelEx", 400, 5, correlation=2),
        _event("kernel", "gemm", 420, 80, correlation=2),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 600, 100, correlation=3),
        _event("kernel", "before", 10, 20, correlation=4),
        _event("cpu_op", "aten::add", 250, 10),
    ]
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    t = tr.read_chrome_trace(path)
    assert (t.start, t.end) == (100, 1100)
    assert [op.name for op in t.ops] == ["conv", "gemm", "Memcpy HtoD (Pinned -> Device)"]
    assert [op.name for op in t.kernels(within="bench.spatial_encoder")] == ["conv"]
    assert t.kernels()[1].ranges == ("bench.window",)
    assert t.window_s == pytest.approx(1e-3)
    parts = tr.breakdown(t)
    assert parts["device_ops"][0] == ["Memcpy HtoD (Pinned -> Device)", pytest.approx(1e-4)]
    assert dict(parts["idle_gaps"])["bench.window"] == pytest.approx((1000 - 130) * 1e-6)
