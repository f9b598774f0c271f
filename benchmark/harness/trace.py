"""Spans around the calls into the program, and the reading of the device trace.

With `--trace 1` the measured window runs under torch.profiler (host and
CUDA activity). The harness opens `record_function` ranges, all named
"bench.*", around its calls into the program and, through forward hooks
(public API: the program is not edited), around the modules a per-layer
metric reads. After the window the profiler's chrome trace is read back:

- every device operation (kernel, copy, set) inside the "bench.window"
  range, with the host ranges that were open when it was launched (joined
  by the CUPTI correlation id of its launch);
- device busy time as the union of operation intervals, so overlapping
  streams count once.

With `--trace 0` every span is a no-op and no hook is installed.
"""

from __future__ import annotations

import gzip
import json
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

WINDOW = "bench.window"
PREFIX = "bench."
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class DeviceOp:
    name: str
    kind: str  # kernel, memcpy or memset
    start: float  # microseconds, on the trace's clock
    end: float
    ranges: Tuple[str, ...] = ()  # host ranges open at its launch, outermost first


@dataclass
class Trace:
    start: float
    end: float
    ops: List[DeviceOp]
    ranges: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def kernels(self, within: Optional[str] = None, name_has: Sequence[str] = ()
                ) -> List[DeviceOp]:
        """Kernels launched inside range `within`, or whose name holds one of
        `name_has`."""
        out = [op for op in self.ops if op.kind == "kernel"]
        if within is not None:
            out = [op for op in out if within in op.ranges]
        if name_has:
            out = [op for op in out if any(s in op.name for s in name_has)]
        return out

    def count(self, name: str) -> int:
        return sum(1 for r in self.ranges if r[0] == name)


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) microsecond intervals, in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def busy_seconds(ops: Iterable[DeviceOp]) -> float:
    return union_seconds((op.start, op.end) for op in ops)


def idle_gaps(trace: Trace, ops: Sequence[DeviceOp]) -> List[Tuple[float, float]]:
    """The intervals of the window in which none of `ops` runs."""
    gaps, cursor = [], trace.start
    for s, e in sorted((op.start, op.end) for op in ops):
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if trace.end > cursor:
        gaps.append((cursor, trace.end))
    return gaps


def open_ranges(ranges: Sequence[Tuple[str, float, float]], times: Sequence[float]
                ) -> List[Tuple[str, ...]]:
    """For each time, the ranges open at it, outermost first (ranges nest:
    they are opened and closed on one thread)."""
    events = [(s, 0, i) for i, (_, s, _) in enumerate(ranges)]
    events += [(t, 1, j) for j, t in enumerate(times)]
    events += [(e, 2, i) for i, (_, _, e) in enumerate(ranges)]
    events.sort()
    stack: List[int] = []
    out: List[Tuple[str, ...]] = [()] * len(times)
    for _, kind, i in events:
        if kind == 0:
            stack.append(i)
        elif kind == 2:
            stack.remove(i)
        else:
            out[i] = tuple(ranges[r][0] for r in stack)
    return out


def read_chrome_trace(path: Path) -> Trace:
    """The device operations of the "bench.window" range of a gzipped chrome
    trace."""
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    ranges, launches, ops = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev["name"].startswith(PREFIX):
            ranges.append((ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(ev["ts"])
        elif cat in DEVICE_CATS:
            ts = float(ev["ts"])
            ops.append((ev["name"], DEVICE_CATS[cat], ts, ts + float(ev.get("dur", 0.0)),
                        ev.get("args", {}).get("correlation")))
    windows = [r for r in ranges if r[0] == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    _, w0, w1 = windows[0]
    ranges = [r for r in ranges if r[1] >= w0 and r[2] <= w1]
    ops = [op for op in ops if op[2] >= w0 and op[3] <= w1]
    at = [launches.get(corr, -1.0) for *_, corr in ops]
    paths = open_ranges(ranges, at)
    return Trace(start=w0, end=w1, ranges=ranges,
                 ops=[DeviceOp(name, kind, s, e, path)
                      for (name, kind, s, e, _), path in zip(ops, paths)])


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    kernel-idle time of the window summed by the innermost host range open
    at each gap's middle."""
    by_op: Dict[str, float] = defaultdict(float)
    for op in trace.ops:
        by_op[op.name] += (op.end - op.start) * 1e-6
    gaps = idle_gaps(trace, trace.kernels())
    paths = open_ranges(trace.ranges, [(s + e) / 2 for s, e in gaps])
    by_host: Dict[str, float] = defaultdict(float)
    for (s, e), path in zip(gaps, paths):
        by_host[path[-1] if path else "outside any range"] += (e - s) * 1e-6
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}


class Tracer:
    """Spans and hooks that record only when `enabled`, and the profiler
    around the window."""

    def __init__(self, enabled: bool, device: torch.device, tmpdir: Path):
        self.enabled = enabled
        self.device = device
        self.path = Path(tmpdir) / "trace.json.gz"  # the profiler writes it gzipped
        self.trace: Optional[Trace] = None
        self._hooks = []

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.enabled else nullcontext()

    def hook(self, module: torch.nn.Module, name: str) -> None:
        """A range around every forward of `module`."""
        if not self.enabled:
            return
        stack = []

        def pre(_module, _inputs):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_module, _inputs, _output):
            stack.pop().__exit__(None, None, None)

        self._hooks += [module.register_forward_pre_hook(pre),
                        module.register_forward_hook(post)]

    @contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        for handle in self._hooks:
            handle.remove()
        prof.export_chrome_trace(str(self.path))
        self.trace = read_chrome_trace(self.path)
        self.path.unlink()


def kernel_idle_percent(trace: Trace) -> Optional[float]:
    """Percent of the window in which no kernel runs (copies count as idle);
    None when the window ran no kernel."""
    kernels = trace.kernels()
    if not kernels:
        return None
    return 100.0 * (1.0 - busy_seconds(kernels) / trace.window_s)
