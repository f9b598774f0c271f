"""The scan's staging slots (inference/scanner.py::_Staging): a batch at or
above STAGE_POOL_MIN_BYTES is filled by the pool of host threads, a smaller
one by the calling thread, and either way the slot and its mask hold exactly
what a serial fill writes: each clip's frames, zeros to the bucket's end,
zero rows past the clips, and no frame of an earlier batch."""

import os

import numpy as np
import pytest
import torch

from video_fingerprint_tpu_torch.inference import scanner as scanner_mod
from video_fingerprint_tpu_torch.inference.scanner import STAGE_POOL_MIN_BYTES, _Staging
from video_fingerprint_tpu_torch.utils import trace

CPU = torch.device("cpu")
FRAME = 64
# slots of the benchmark's scan cells, 64 rows of 64x64x3 uint8: bucket 32
# (the smallest, filled serially) and bucket 64 (the smallest on the pool);
# a float32 slot holds as many bytes at a quarter of the bucket
BUCKET_32_SLOT = 64 * 32 * FRAME * FRAME * 3
BUCKET_64_SLOT = 2 * BUCKET_32_SLOT


def _clips(rng, lengths, dtype):
    shape = (FRAME, FRAME, 3)
    if dtype == torch.uint8:
        return [rng.integers(0, 256, (t,) + shape, dtype=np.uint8) for t in lengths]
    return [rng.random((t,) + shape, dtype=np.float32) for t in lengths]


def _serial(batch, bucket, clips, dtype):
    """The fill as one loop over the rows writes it."""
    frames = np.zeros((batch, bucket, FRAME, FRAME, 3),
                      np.uint8 if dtype == torch.uint8 else np.float32)
    mask = np.zeros((batch, bucket), bool)
    for i, clip in enumerate(clips):
        frames[i, :clip.shape[0]] = clip
        mask[i, :clip.shape[0]] = True
    return frames, mask


def _stage(staging, bucket, clips):
    before = trace.counter("embed.fill_pooled")
    frames, mask = staging.stage(bucket, clips)
    return frames.numpy(), mask.numpy(), trace.counter("embed.fill_pooled") - before


def test_threshold_lies_between_the_cells_two_smallest_slots():
    assert BUCKET_32_SLOT < STAGE_POOL_MIN_BYTES <= BUCKET_64_SLOT


@pytest.mark.parametrize("dtype,bucket", [(torch.uint8, 64), (torch.float32, 16)],
                         ids=["uint8", "float32"])
@pytest.mark.parametrize("clips_in_batch", [64, 37], ids=["full", "partial"])
def test_pooled_fill_equals_the_serial_fill(dtype, bucket, clips_in_batch):
    """Two batches into the one CPU slot: clips as long as the bucket, then
    shorter ones of mixed lengths, so a stale frame of the first would show
    in the second's padding; each slot and mask equal the serial fill's."""
    rng = np.random.default_rng(clips_in_batch)
    staging = _Staging(CPU, 64, FRAME, dtype)
    assert 64 * bucket * FRAME * FRAME * 3 * dtype.itemsize == BUCKET_64_SLOT
    shorter = [1] + rng.integers(1, bucket, clips_in_batch - 1).tolist()
    for lengths in ([bucket] * 64, shorter):
        clips = _clips(rng, lengths, dtype)
        frames, mask, pooled = _stage(staging, bucket, clips)
        ref_frames, ref_mask = _serial(64, bucket, clips, dtype)
        assert pooled == 1
        assert frames.tobytes() == ref_frames.tobytes()
        assert np.array_equal(mask, ref_mask)
    assert not frames[clips_in_batch:].any() and not mask[clips_in_batch:].any()
    assert not frames[0, 1:].any() and mask[0].sum() == 1


@pytest.mark.parametrize("dtype,bucket", [(torch.uint8, 32), (torch.float32, 8)],
                         ids=["uint8", "float32"])
def test_small_batch_fills_on_the_calling_thread(dtype, bucket):
    """A batch under the threshold (the cells' bucket-32 slot) is filled
    serially: no pooled count, and the same bytes."""
    rng = np.random.default_rng(3)
    staging = _Staging(CPU, 64, FRAME, dtype)
    assert 64 * bucket * FRAME * FRAME * 3 * dtype.itemsize == BUCKET_32_SLOT
    staging.stage(bucket, _clips(rng, [bucket] * 64, dtype))
    clips = _clips(rng, [3, bucket, 1], dtype)
    frames, mask, pooled = _stage(staging, bucket, clips)
    ref_frames, ref_mask = _serial(64, bucket, clips, dtype)
    assert pooled == 0
    assert frames.tobytes() == ref_frames.tobytes() and np.array_equal(mask, ref_mask)


def test_a_worker_error_reaches_the_caller():
    """A clip the slot cannot take fails the pooled fill in the caller, and
    no pooled batch is counted."""
    staging = _Staging(CPU, 64, FRAME, torch.uint8)
    clips = [np.zeros((64, FRAME, FRAME, 3), np.uint8)] * 63 + [
        np.zeros((64, FRAME // 2, FRAME // 2, 3), np.uint8)]
    before = trace.counter("embed.fill_pooled")
    with pytest.raises(ValueError):
        staging.stage(64, clips)
    assert trace.counter("embed.fill_pooled") == before


def test_one_pool_of_bounded_threads_is_shared():
    """Every staging fills on the one pool, of at most STAGE_POOL_THREADS
    threads and no more than the cores the process may use."""
    rng = np.random.default_rng(4)
    for _ in range(2):
        _Staging(CPU, 64, FRAME, torch.uint8).stage(64, _clips(rng, [5] * 64, torch.uint8))
    pool = scanner_mod._stage_pool()
    assert pool is scanner_mod._stage_pool()
    assert scanner_mod.stage_pool_threads() == min(scanner_mod.STAGE_POOL_THREADS,
                                                    len(os.sched_getaffinity(0)))
    assert pool._max_workers == scanner_mod.stage_pool_threads()
