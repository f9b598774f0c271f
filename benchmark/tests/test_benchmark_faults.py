"""The check catches the faults a cell can have: whole runs on the CPU with
the timed path broken underneath, skipping only the look for a card.

A scan cell can lose videos from its batches or alter an answer where it is
produced (an embedding, a duplicate group); the search can alter a score or
a row, or answer only half of a call's queries. A call that answers its
queries in several searches, in another order, is no fault. The cells have no state a
step could leave unchanged and run on one card, with no exchange to drop.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark.harness import main

from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

CPU = torch.device("cpu")


def _run(root, cell):
    return main.run_cell(root, cell, 2**31 + 303, 0.3, False, CPU, time.perf_counter(),
                         root / "benchmark")


def _broken(monkeypatch, cls, name, wrap):
    original = getattr(cls, name)
    monkeypatch.setattr(cls, name, lambda self, *a, **k: wrap(original(self, *a, **k)))


@pytest.mark.parametrize("cell", ["tiny-attn-scan", "tiny-cnn3d-scan"])
def test_benchmark_half_of_each_batch_left_out(monkeypatch, tiny_root, cell):
    def half(out):
        return {key: e for i, (key, e) in enumerate(out.items()) if i % 2 == 0}

    _broken(monkeypatch, FingerprintScanner, "embed_clips", half)
    line = _run(tiny_root, cell)
    assert line["correct"] is False and line["failed"] > 0


@pytest.mark.parametrize("cell", ["tiny-attn-scan", "tiny-cnn3d-scan"])
def test_benchmark_embedding_altered(monkeypatch, tiny_root, cell):
    def altered(out):
        for key in list(out)[::4]:
            out[key] = np.roll(out[key], 1)
        return out

    _broken(monkeypatch, FingerprintScanner, "embed_clips", altered)
    line = _run(tiny_root, cell)
    assert line["correct"] is False
    assert line["checks"]["embedding_gap"]["value"] > line["checks"]["embedding_gap"]["limit"]


def test_benchmark_group_altered(monkeypatch, tiny_root):
    def dropped(groups):
        assert groups, "the tiny library plants byte copies, so a scan finds groups"
        return groups[:-1]

    _broken(monkeypatch, FingerprintScanner, "find_duplicates", dropped)
    line = _run(tiny_root, "tiny-attn-scan")
    assert line["correct"] is False and line["checks"]["group_mismatch"]["value"] > 0


@pytest.mark.parametrize("fault", ["score", "row"])
def test_benchmark_search_answer_altered(monkeypatch, tiny_root, fault):
    def altered(result):
        scores, idx = result
        scores, idx = scores.copy(), idx.copy()
        if fault == "score":
            scores[0, 0] += 1e-3
        else:
            idx[0, 0] = (idx[0, 0] + 1) % 5000
        return scores, idx

    _broken(monkeypatch, FingerprintIndex, "search", altered)
    line = _run(tiny_root, "tiny-search")
    assert line["correct"] is False


def test_benchmark_search_half_of_the_batch_left_out(monkeypatch, tiny_root):
    original = FingerprintScanner.find_duplicates_against

    def half(self, fingerprints, index, *args, **kwargs):
        kept = dict(list(fingerprints.items())[::2])
        return original(self, kept, index, *args, **kwargs)

    monkeypatch.setattr(FingerprintScanner, "find_duplicates_against", half)
    line = _run(tiny_root, "tiny-search")
    assert line["correct"] is False and line["failed"] > 0


def test_benchmark_search_in_several_searches_is_correct(monkeypatch, tiny_root):
    """A call that searches its queries in two chunks, the second half
    first, is judged by its answers, as one search would be."""
    original = FingerprintScanner.find_duplicates_against

    def chunked(self, fingerprints, index, *args, **kwargs):
        items = list(fingerprints.items())
        half = len(items) // 2
        return (original(self, dict(items[half:]), index, *args, **kwargs)
                + original(self, dict(items[:half]), index, *args, **kwargs))

    monkeypatch.setattr(FingerprintScanner, "find_duplicates_against", chunked)
    line = _run(tiny_root, "tiny-search")
    assert line["correct"] is True and line["failed"] == 0


def test_benchmark_search_without_the_index_search(monkeypatch, tiny_root):
    """A call whose answers come from no `FingerprintIndex.search` leaves its
    queries without an answer to judge: they count as missing."""
    def unrecorded(self, fingerprints, index, *args, **kwargs):
        return []

    monkeypatch.setattr(FingerprintScanner, "find_duplicates_against", unrecorded)
    line = _run(tiny_root, "tiny-search")
    assert line["correct"] is False and line["checks"]["missing_queries"]["value"] > 0
