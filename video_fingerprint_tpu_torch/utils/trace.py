"""Spans, counters and the profiler exporter of the port.

- `span(name, request=None)` marks a stretch of host time. While a
  `torch.profiler` session records on the calling thread
  (`torch.autograd._profiler_enabled()`), it opens
  `record_function("vfp." + name)`, so the span lands in the profiler's
  chrome trace on the same timeline as the CUDA kernels, and appends one
  `Span` to an in-memory record when it closes. Otherwise it returns one
  shared `nullcontext` after that single flag read: no clock, no event, no
  synchronisation. `parent` is the span open on the same thread, and a span
  opened without a `request` takes its parent's, so every span of one batch
  or one call carries that batch's or call's id (`new_request`).
- `count(name, n=1)` adds to a process total, read by `counter(name)`;
  while a profiler records, the increment also goes to the record.
- `recorded()` is what was recorded while profilers ran in this process:
  the spans, each name's self seconds (its spans' durations less the parts
  their children on the same thread cover) and the counter increments.
  `clear()` empties it.
- `profile(out_dir, device)` runs a profiler session (host and, on a card,
  CUDA activity) and writes `out_dir/trace.json`.

The profiler's enabled state is per thread: spans opened on a thread that
did not start the session (a decode worker) are not recorded.

Spans of the port, by module (benchmark/metrics/ reads them by name):

  inference/scanner.py
    embed.batch          one batch: its staging, forward and dispatch
    embed.slot_wait      the host waits for a pinned slot's last copy
    embed.fill           clips padded and copied into the pinned slot (by
                         the fill pool's threads for a large batch, the
                         span then being the calling thread's wait)
    embed.forward        the forward and the readback's enqueue
    embed.readback_wait  the wait for an earlier batch's result (that
                         batch's request) and its hand-off
    decode.queue_wait    the batching stage waits on the decode threads
    scan.reduce_windows  one 3D video's window embeddings reduced to its
                         fingerprint (`reduce_windows`); the attention
                         path has none
    against.call         one `find_duplicates_against` call, with
    against.prepare      its identity checks and stacked queries, and
    against.group        its grouping and exact-duplicate tagging
  inference/index.py
    index.search         one search, with
    index.upload         the queries' copy to the card, and
    index.readback       the results' copy back
  ops/topk.py
    topk.sync            the host waits on a device result (`nonzero`):
                         the certified methods and the plain exact path;
                         the exact search on a card has none
  parallel/distributed.py
    collective           one collective, with its host copies under gloo

Counters: `embed.frames_staged` and `embed.frames_useful` (frames of each
staged batch, padding included, and the clips' own), `embed.fill_pooled`
(staged batches whose fill ran on the fill pool, one a batch and shard),
`scan.windows_reduced` and `scan.videos_reduced` (the 3D windows and the
videos `reduce_windows` took in and gave out), `k1.launches`,
`convblock.<entry>`, `conv_int8.<entry>` (kernel launches per entry
point), `topk.launches` (launches of the exact search's two kernels, two a
search), `topk.repaired_rows` (rows the certified searches repaired), and
`stem.launches`, `stem.frames` and `stem.blocks` (K6's launches, one a bf16
forward of the attention model on a card, the frames they took and the
blocks of their persistent grids).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Hashable, List, NamedTuple, Optional

import torch

PREFIX = "vfp."

_OFF = nullcontext()
_lock = threading.Lock()
_local = threading.local()
_requests = itertools.count()
_totals: Dict[str, int] = defaultdict(int)


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: Optional[str]
    request: Hashable
    thread: int


@dataclass
class Record:
    spans: List[Span] = field(default_factory=list)
    self_seconds: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counts: Dict[str, int] = field(default_factory=lambda: defaultdict(int))


_record = Record()


class _Open:
    """A span being recorded: its profiler range and its frame on the
    thread's stack."""

    __slots__ = ("name", "request", "parent", "children_ns", "start", "range")

    def __init__(self, name: str, request: Hashable):
        self.name = name
        self.request = request
        self.children_ns = 0

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        if self.request is None and self.parent is not None:
            self.request = self.parent.request
        stack.append(self)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _local.stack.pop()
        took = end - self.start
        parent = self.parent
        if parent is not None:
            parent.children_ns += took
        with _lock:
            _record.spans.append(Span(self.name, self.start, end,
                                      parent.name if parent is not None else None,
                                      self.request, threading.get_ident()))
            _record.self_seconds[self.name] += (took - self.children_ns) * 1e-9
        return False


def span(name: str, request: Hashable = None):
    """A context manager around one stretch of host time (module docstring)."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Open(name, request)


def new_request() -> int:
    """A request id no other batch or call of this process has."""
    return next(_requests)


def count(name: str, n: int = 1) -> None:
    with _lock:
        _totals[name] += n
        if torch.autograd._profiler_enabled():
            _record.counts[name] += n


def counter(name: str) -> int:
    """The process total of counter `name` (0 before its first count)."""
    return _totals.get(name, 0)


def recorded() -> Record:
    """What was recorded while profilers ran in this process."""
    return _record


def clear() -> None:
    global _record
    with _lock:
        _record = Record()


@contextmanager
def profile(out_dir, device: torch.device):
    """A profiler session around the block (host activity, and CUDA's on a
    card), whose chrome trace goes to out_dir/trace.json once the card's
    queued work has finished."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    print(f"profiler trace written to {out}")
