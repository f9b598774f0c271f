"""The port's spans and counters (utils/trace.py): nothing recorded without a
profiler, the spans of the scan's batching stage and of the `--against`
search with their parents and requests (a pooled fill's included), the
staged and useful frame counts, the 3D window reduction's span and counts,
and the chrome traces of `trace.profile` and the scan CLI's `--profile`."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tests.test_torch_port_scan import _cap_torch_threads, ckpt, corpus, scanner  # noqa: F401
from tests.test_torch_port_scan3d import checkpoints, corpus3d, scanner3d  # noqa: F401
from video_fingerprint_tpu_torch.cli.scan import main
from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.utils import trace

CPU = torch.device("cpu")
# clip lengths for the fixture scanner (batch 4, buckets 32 / 64 / 500):
# bucket 32 fills one batch and leaves one clip, bucket 64 holds three
LENGTHS = (10, 20, 12, 31, 33, 5, 40, 64)


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _clips(lengths=LENGTHS):
    rng = np.random.default_rng(0)
    return [(f"clip_{i}", rng.integers(0, 256, (t, 64, 64, 3), dtype=np.uint8))
            for i, t in enumerate(lengths)]


def _within(inner, outer):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_no_profiler_records_nothing_and_counters_count():
    trace.clear()
    assert trace.span("a") is trace.span("b", request=3)  # one shared no-op
    with trace.span("a"):
        trace.count("test.things", 2)
    before = trace.counter("test.things")
    trace.count("test.things")
    assert trace.counter("test.things") == before + 1
    assert trace.counter("test.never") == 0
    record = trace.recorded()
    assert record.spans == [] and not record.self_seconds and not record.counts


def test_self_time_parents_and_requests():
    """A span without a request takes its parent's; self time is the
    duration less the children's on the same thread; counts made under the
    profiler go to the record as well."""
    trace.clear()
    with _profiled():
        with trace.span("outer", request=7):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.002)
                trace.count("test.recorded", 5)
            with trace.span("inner", request=8):
                pass
    record = trace.recorded()
    outer, = [s for s in record.spans if s.name == "outer"]
    inner = [s for s in record.spans if s.name == "inner"]
    assert outer.parent is None and outer.request == 7
    assert [(s.parent, s.request) for s in inner] == [("outer", 7), ("outer", 8)]
    assert all(_within(s, outer) for s in inner)
    children = sum(s.end_ns - s.start_ns for s in inner)
    assert record.self_seconds["outer"] == pytest.approx(
        (outer.end_ns - outer.start_ns - children) * 1e-9)
    assert record.self_seconds["inner"] == pytest.approx(children * 1e-9)
    assert record.self_seconds["outer"] >= 0.0015
    assert record.counts["test.recorded"] == 5
    trace.clear()
    assert trace.recorded().spans == []


def test_embed_clips_spans_and_chrome_trace(scanner, tmp_path):
    """Each batch's span holds its fill and forward; the wait for a batch's
    result runs inside the next batch's span with the earlier batch's
    request, and the last one after the final batch. The chrome trace holds
    the same spans as nested vfp.* ranges."""
    _check_embed_clips_spans(scanner, tmp_path)


def test_pooled_fill_keeps_its_spans_on_the_calling_thread(scanner, tmp_path, monkeypatch):
    """With every batch over the pooling threshold, each batch still has one
    `embed.fill` span and one vfp.embed.fill range, and every span and vfp.*
    range is the calling thread's: the pool's workers record none."""
    monkeypatch.setattr(scanner_mod, "STAGE_POOL_MIN_BYTES", 0)
    before = trace.counter("embed.fill_pooled")
    spans, events = _check_embed_clips_spans(scanner, tmp_path)
    assert trace.counter("embed.fill_pooled") - before == 3
    assert trace.recorded().counts["embed.fill_pooled"] == 3
    assert {s.thread for s in spans} == {threading.get_ident()}
    assert len({ev["tid"] for ev in events if ev["name"].startswith(trace.PREFIX)}) == 1


def _check_embed_clips_spans(scanner, tmp_path):
    """The embed_clips span checks of the two tests above: (spans, chrome
    trace events)."""
    trace.clear()
    with trace.profile(tmp_path, CPU):
        out = scanner.embed_clips(_clips())
    assert set(out) == {f"clip_{i}" for i in range(len(LENGTHS))}
    spans = trace.recorded().spans
    batches = [s for s in spans if s.name == "embed.batch"]
    assert len(batches) == 3  # bucket 32 full, then its partial batch, then 64
    requests = [b.request for b in batches]
    assert requests == sorted(set(requests))
    for name in ("embed.fill", "embed.forward"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == 3
        for s, b in zip(inner, batches):
            assert (s.parent, s.request) == ("embed.batch", b.request) and _within(s, b)
    waits = [s for s in spans if s.name == "embed.readback_wait"]
    assert [w.request for w in waits] == requests
    for w, b in zip(waits[:-1], batches[1:]):
        assert w.parent == "embed.batch" and _within(w, b)
    assert waits[-1].parent is None and waits[-1].start_ns >= batches[-1].end_ns
    assert not [s for s in spans if s.name == "embed.slot_wait"]  # one slot on a CPU

    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for ev in events:
        if ev.get("ph") == "X" and ev["name"].startswith(trace.PREFIX):
            ranges.setdefault(ev["name"], []).append((ev["ts"], ev["ts"] + ev["dur"]))
    assert len(ranges["vfp.embed.batch"]) == 3 and len(ranges["vfp.embed.fill"]) == 3
    for lo, hi in ranges["vfp.embed.fill"]:
        assert any(b0 <= lo and hi <= b1 for b0, b1 in ranges["vfp.embed.batch"])
    return spans, [ev for ev in events if ev.get("ph") == "X"]


def test_staged_and_useful_frame_counts(scanner):
    """Staged frames are batch x bucket per batch, padding rows included;
    useful frames are the clips' own, in the totals and in the record."""
    staged = 4 * 32 + 4 * 32 + 4 * 64  # the full and partial 32 batches, one of 64
    useful = sum(LENGTHS)
    before = {n: trace.counter(n) for n in ("embed.frames_staged", "embed.frames_useful")}
    trace.clear()
    with _profiled():
        scanner.embed_clips(_clips())
    counts = trace.recorded().counts
    assert (counts["embed.frames_staged"], counts["embed.frames_useful"]) == (staged, useful)
    assert trace.counter("embed.frames_staged") - before["embed.frames_staged"] == staged
    assert trace.counter("embed.frames_useful") - before["embed.frames_useful"] == useful


def test_window_reduction_span_and_counts(scanner3d, corpus3d):  # noqa: F811
    """One 3D scan: a `scan.reduce_windows` span a video, and the counts of
    the windows reduced and of the videos they gave, exactly, in the record
    and in the process totals."""
    names = ("scan.windows_reduced", "scan.videos_reduced")
    windows = 3 * len(scanner3d.window_plan(80)) + 1  # three 80-frame videos, one of 12
    assert windows == 10
    before = {n: trace.counter(n) for n in names}
    trace.clear()
    with _profiled():
        fingerprints = scanner3d.scan_directory(corpus3d, num_workers=2, batched=True)
    assert len(fingerprints) == 4
    record = trace.recorded()
    assert [record.counts[n] for n in names] == [windows, 4]
    assert [trace.counter(n) - before[n] for n in names] == [windows, 4]
    spans = [s for s in record.spans if s.name == "scan.reduce_windows"]
    assert len(spans) == 4 and all(s.parent is None for s in spans)


def test_attention_scan_reduces_no_windows(scanner, corpus):  # noqa: F811
    names = ("scan.windows_reduced", "scan.videos_reduced")
    before = {n: trace.counter(n) for n in names}
    trace.clear()
    with _profiled():
        assert scanner.scan_directory(corpus, num_workers=2, batched=True)
    record = trace.recorded()
    assert record.spans and not [s for s in record.spans if s.name.startswith("scan.")]
    assert not set(names) & set(record.counts)
    assert all(trace.counter(n) == before[n] for n in names)


def test_against_spans_and_parents(scanner):
    """One `--against` call: its preparation, the index search (the query
    upload, the host waits of the top-k, the readback) and the grouping,
    all under the call's span and request."""
    rng = np.random.default_rng(1)
    corpus_rows = rng.standard_normal((300, 256)).astype(np.float32)
    corpus_rows /= np.linalg.norm(corpus_rows, axis=1, keepdims=True)
    index = FingerprintIndex(dim=256, device="cpu")
    index.add(corpus_rows, [{"path": f"lib/{i}.mp4", "file_hash": f"{i:032x}"}
                            for i in range(300)])
    fingerprints = {f"new/{i}.mp4": {"embedding": corpus_rows[i * 7], "path": f"new/{i}.mp4",
                                     "file_hash": f"{i * 7:032x}"} for i in range(5)}
    trace.clear()
    with _profiled():
        groups = scanner.find_duplicates_against(fingerprints, index, 0.99, k=5)
    assert len(groups) == 5 and all(g[1]["exact_duplicate"] for g in groups)
    spans = trace.recorded().spans
    call, = [s for s in spans if s.name == "against.call"]
    parents = {"against.prepare": "against.call", "index.search": "against.call",
               "against.group": "against.call", "index.upload": "index.search",
               "topk.sync": "index.search", "index.readback": "index.search"}
    for name, parent in parents.items():
        found = [s for s in spans if s.name == name]
        assert found, name
        for s in found:
            assert (s.parent, s.request) == (parent, call.request) and _within(s, call), name
    assert {s.name for s in spans} == set(parents) | {"against.call"}


def test_scan_cli_profile_writes_the_spans(ckpt, corpus, tmp_path):  # noqa: F811
    """`--profile DIR`: the scan and its duplicate search in one chrome trace,
    with the batching stage's spans and its waits on the decode threads."""
    rc = main(["--model", ckpt, "--scan", str(corpus), "--threshold", "0.999999",
               "--device", "cpu", "--workers", "2", "--batch", "4",
               "--profile", str(tmp_path / "profile")])
    assert rc == 0
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    names = {ev["name"] for ev in events if ev.get("ph") == "X"}
    assert {"vfp.embed.batch", "vfp.embed.fill", "vfp.embed.forward",
            "vfp.embed.readback_wait", "vfp.decode.queue_wait"} <= names
