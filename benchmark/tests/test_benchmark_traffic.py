"""The traffic generator: seeded, repeatable, and the mixes as BENCHMARK.json
names them (length classes, planted copies, planted queries)."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import REPO, TINY_CONFIGS, TINY_MIXES
from benchmark.drivers import index_search, library_scan
from benchmark.harness import traffic

CPU = torch.device("cpu")
SCAN_MIXES = ("attn-library-long", "cnn3d-library-long", "attn-library-short")
CONFIG_OF = {"attn-library-long": "attention-ref-full", "attn-library-short": "attention-ref-full",
             "cnn3d-library-long": "cnn3d-ref-full"}


def _mix(name):
    return json.loads((REPO / "benchmark" / "traffic" / f"{name}.json").read_text())


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def _decoded(mix, config, seed):
    """Per video: the clip lengths the library gives it, without rendering."""
    originals, copies, _ = library_scan._library_plan(mix, np.random.default_rng(seed))
    sources = list(originals) + [src for _, _, src in copies]
    if config["model_type"] == "attention":
        return [[len(traffic.subsample_times(int(s), config["max_frames"]))] for s in sources]
    return [[length for _, length in traffic.window_plan(int(s), config["clip_length"])]
            for s in sources]


@pytest.mark.parametrize("name", SCAN_MIXES)
def test_benchmark_library_sizes_are_the_same_for_every_seed(name):
    mix, config = _mix(name), _config(CONFIG_OF[name])
    first = sorted(map(tuple, _decoded(mix, config, 1)))
    assert len(first) == mix["videos"]
    for seed in (2, 2**31 + 77, 2**40 + 3):
        assert sorted(map(tuple, _decoded(mix, config, seed))) == first


def test_benchmark_long_attention_mix():
    """80 % of the originals decode to 500 frames; a twentieth of the library
    are copies, half byte copies."""
    mix, config = _mix("attn-library-long"), _config("attention-ref-full")
    originals, copies, slots = library_scan._library_plan(mix, np.random.default_rng(5))
    decoded = [len(traffic.subsample_times(int(s), 500)) for s in originals]
    assert sum(d == 500 for d in decoded) == round(0.8 * len(originals))
    assert all(10 <= d <= 499 for d in decoded if d != 500)
    assert len(copies) == round(1024 / 20) and sorted(slots) == list(range(1024))
    assert sum(byte for _, byte, _ in copies) == round(len(copies) / 2)


def test_benchmark_3d_mix_windows():
    mix, config = _mix("cnn3d-library-long"), _config("cnn3d-ref-full")
    originals, _, _ = library_scan._library_plan(mix, np.random.default_rng(5))
    counts = [len(traffic.window_plan(int(s), 128)) for s in originals]
    n = len(originals)
    assert sum(c == 5 for c in counts) == round(0.7 * n)
    assert sum(c in (3, 4) for c in counts) == round(0.2 * n)
    assert sum(c == 1 for c in counts) == n - round(0.7 * n) - round(0.2 * n)


def test_benchmark_short_mix_lengths():
    mix = _mix("attn-library-short")
    originals, _, _ = library_scan._library_plan(mix, np.random.default_rng(5))
    assert originals.min() >= 10 and originals.max() <= 256


def test_benchmark_window_plan_is_the_reference_rule():
    assert traffic.window_plan(100, 128) == [(0, 100)]
    assert traffic.window_plan(300, 128) == [(0, 128), (86, 128), (172, 128)]
    assert len(traffic.window_plan(1280, 128)) == 5
    assert traffic.subsample_times(1200, 500)[:3].tolist() == [0, 2, 4]


def test_benchmark_library_repeats_for_a_seed_and_changes_with_it():
    mix, config = TINY_MIXES["tiny-attn-scan"], TINY_CONFIGS["tiny-attention"]
    a = library_scan.build_library(mix, config, 2**31 + 5, CPU)
    b = library_scan.build_library(mix, config, 2**31 + 5, CPU)
    c = library_scan.build_library(mix, config, 2**31 + 6, CPU)
    assert np.array_equal(a.frames, b.frames)
    assert [v.path for v in a.videos] == [v.path for v in b.videos]
    assert [v.file_hash for v in a.videos] == [v.file_hash for v in b.videos]
    assert a.frames.shape == c.frames.shape and not np.array_equal(a.frames, c.frames)


def test_benchmark_copies_share_their_original():
    mix, config = TINY_MIXES["tiny-attn-scan"], TINY_CONFIGS["tiny-attention"]
    lib = library_scan.build_library(mix, config, 11, CPU)
    by_slot = {int(v.path[-10:-4]): v for v in lib.videos}
    copies = [v for v in lib.videos if v.copy_of is not None]
    assert len(copies) == round(0.1 * mix["videos"])
    for v in copies:
        original = by_slot[v.copy_of]
        if v.byte_copy:
            assert v.file_hash == original.file_hash
            assert np.array_equal(v.clips[0], original.clips[0])
        else:
            assert v.file_hash != original.file_hash and v.source < original.source


def test_benchmark_search_traffic():
    mix, config = TINY_MIXES["tiny-search"], TINY_CONFIGS["tiny-attention"]
    a = index_search.build_search(mix, config, 2**33, CPU)
    b = index_search.build_search(mix, config, 2**33, CPU)
    assert np.array_equal(a.index, b.index) and np.array_equal(a.batches[3], b.batches[3])
    assert np.allclose(np.linalg.norm(a.index, axis=1), 1, atol=1e-5)
    per_batch = round(mix["queries_per_call"] * mix["planted"]["share"])
    for q, planted in zip(a.batches, a.planted):
        assert len(planted) == per_batch
        cos = [float(q[r] @ a.index[t]) for r, t in planted.items()]
        assert min(cos) >= 0.995 - 1e-5 and max(cos) <= 0.999 + 1e-5
        sims = q @ a.index.T
        # every query at or above 0.99 to a row is a planted one
        assert set(np.nonzero((sims >= 0.99).any(axis=1))[0]) == set(planted)
