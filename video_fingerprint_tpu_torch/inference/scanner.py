"""Fingerprint scanner: directory scan -> embeddings -> duplicate groups.

Port of video_fingerprint_tpu/inference/scanner.py, for both model
families:

  - the checkpoint (`.ckpt` or reference `.pth`) loads, BatchNorm folds into
    the convs (on by default), and the model is rebuilt from the embedded
    config;
  - a decode producer (`_decode_ahead`, bounded) turns paths into uint8
    clips on host threads. The attention model takes one subsampled clip
    per video; the 3D model takes windows of up to `clip_length` frames
    (`window_plan`: one window for a short video, 3-5 evenly strided ones
    for a longer one). With `native_decode` the native libav worker
    (utils/native_decode.py) decodes, scales and crops in one pass; with
    `native_preprocess` (and no native decode) cv2 decodes and the native
    thread pool (utils/native.py) resizes, crops and normalizes the
    attention clips to float32, which are then staged as float32;
  - the batching stage (`embed_clips`) pads each clip to a length bucket
    and forwards fixed-shape batches: the attention model masks the padding
    (partial batches get rows whose mask is all False); the 3D model's
    buckets are multiples of its frame stride, where zero padding is the
    model's own. Staging buffers are pinned, the copies to and from the
    card are asynchronous, and one batch's result is read back only after
    the next batch is on its way. A batch of STAGE_POOL_MIN_BYTES or more
    is padded into its slot by a pool of host threads, a row a task. Its
    spans (`embed.*`, `decode.queue_wait`), its counts of staged and useful
    frames and of pooled fills are utils/trace.py's;
  - a 3D video's windows reduce to one embedding: a single window's as it
    is, several windows' mean renormalized (`reduce_windows`, with its
    span `scan.reduce_windows` and its counts of windows and videos);
  - an optional cache of an earlier scan (inference/scan_cache.py) skips
    every file whose size and md5 of the first MiB are unchanged;
  - duplicates are grouped (inference/dedup.py) from the full similarity
    matrix (up to 100 videos) or from exact top-k candidates, or searched
    against a saved corpus (`find_duplicates_against`).

Entry points run on the card (device="cuda") unless the caller asks for the
CPU. In float32 mode every forward and similarity runs with TF32 off for
cuDNN convolutions and cuBLAS matmuls, so embeddings hold the JAX
package's f32 results.
"""

from __future__ import annotations

import copy
import hashlib
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing, contextmanager
from itertools import islice
from pathlib import Path
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_fingerprint_tpu_torch.data import decode, preprocess
from video_fingerprint_tpu_torch.inference import dedup
from video_fingerprint_tpu_torch.inference.index import identity_mismatch
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.ops.topk import (shard_search, sharded_topk_cosine,
                                                 topk_cosine)
from video_fingerprint_tpu_torch.parallel.mesh import as_devices, pad_to_multiple
from video_fingerprint_tpu_torch.training.checkpoint import load_any
from video_fingerprint_tpu_torch.utils import native, trace
from video_fingerprint_tpu_torch.utils import native_decode as native_decode_lib
from video_fingerprint_tpu_torch.utils.device import resolve_device
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.torch_compat import variables_to_state_dict

DEFAULT_EXTENSIONS = [".mp4", ".avi", ".mov", ".mkv", ".webm", ".flv"]
SCAN_BUCKETS = (32, 64, 128, 256, 512)
MIN_FRAMES = 10  # reference minimum (fingerprint.py:238-240)
MODEL_TYPES = ("attention", "3d", "cnn3d")
# The fill of a staging slot: a batch of at least STAGE_POOL_MIN_BYTES is
# padded into its slot by up to STAGE_POOL_THREADS host threads, a row a
# task (numpy's copies release the GIL); a smaller one by the calling thread.
# On the H100's 8-core host the fill's GB/s stops rising at 8 threads, and a
# 25 MB slot filled serially beat the pool while 50 MB and larger gained
# (PERF.md §5).
STAGE_POOL_THREADS = 8
STAGE_POOL_MIN_BYTES = 32 << 20

_fill_pool: Optional[ThreadPoolExecutor] = None
_fill_pool_lock = threading.Lock()


def stage_pool_threads() -> int:
    """The fill pool's threads: the cores this process may run on, at most
    STAGE_POOL_THREADS."""
    return min(STAGE_POOL_THREADS, len(os.sched_getaffinity(0)))


def _stage_pool() -> ThreadPoolExecutor:
    """The process's fill pool, made at its first use; every staging shares
    it (the data-parallel shards fill in turn)."""
    global _fill_pool
    with _fill_pool_lock:
        if _fill_pool is None:
            _fill_pool = ThreadPoolExecutor(max_workers=stage_pool_threads(),
                                            thread_name_prefix="vfp-stage")
        return _fill_pool


def _decode_ahead(jobs: Iterable, load, num_workers: int) -> Iterator:
    """(job, load(job)) for each job, in job order, from a pool of
    num_workers threads with at most 4 * num_workers jobs submitted and not
    yet consumed (the one the consumer holds included). Each wait is a
    `decode.queue_wait` span; closing cancels the jobs not yet started."""
    workers = max(1, num_workers)
    jobs, ahead = iter(jobs), deque()
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="vfp-decode")
    try:
        while True:
            ahead.extend((job, pool.submit(load, job))
                         for job in islice(jobs, 4 * workers - len(ahead)))
            if not ahead:
                return
            job, future = ahead.popleft()
            with trace.span("decode.queue_wait"):
                result = future.result()
            yield job, result
    finally:
        pool.shutdown(cancel_futures=True)


def _fill_row(frames: np.ndarray, mask: np.ndarray, clips: Sequence[np.ndarray],
              i: int) -> None:
    """Row i of a staging slot: clip i's frames, zeros to the bucket's end and
    the mask of its frames; past the clips, zeros and an all-False mask. It
    opens no span: a worker thread's would not be recorded."""
    t = clips[i].shape[0] if i < len(clips) else 0
    if t:
        frames[i, :t] = clips[i]
    frames[i, t:] = 0
    mask[i, :t] = True
    mask[i, t:] = False


class _Readback:
    """A device result on its way to the host: on CUDA an asynchronous copy
    into pinned memory, completed by `wait()`."""

    def __init__(self, result: torch.Tensor):
        self._done = None
        if result.is_cuda:
            self._host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
            self._host.copy_(result, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(result.device))
        else:
            self._host = result

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


class _Gathered:
    """The readbacks of one batch's shards (one without data parallel),
    joined in shard order."""

    def __init__(self, parts: List[_Readback]):
        self._parts = parts

    def wait(self) -> np.ndarray:
        return np.concatenate([part.wait() for part in self._parts])


class _AsyncPipeline:
    """One-deep dispatch/readback pipeline: the previous batch's result is
    read back only after the next batch has been dispatched, overlapping
    the copies and compute of one batch with the readback of the other."""

    def __init__(self, on_result):
        self._inflight: List[Tuple[Any, _Readback, Hashable]] = []
        self._on_result = on_result

    def dispatch(self, context, readback: _Readback, request: Hashable) -> None:
        self._inflight.append((context, readback, request))
        while len(self._inflight) > 1:
            self._drain_one()

    def _drain_one(self) -> None:
        context, readback, request = self._inflight.pop(0)
        with trace.span("embed.readback_wait", request):
            self._on_result(context, readback.wait())

    def finish(self) -> None:
        while self._inflight:
            self._drain_one()


class _Staging:
    """Host buffers in which batches are assembled, per bucket length.

    On CUDA they are pinned and the copies to the card are asynchronous, so
    each bucket has two slots used in turn, and a slot is refilled only after
    the event recorded behind its last copy has completed. On the CPU one
    slot per bucket suffices: its forward has finished before the next fill.
    """

    def __init__(self, device: torch.device, batch_size: int, frame_size: int,
                 dtype: torch.dtype = torch.uint8):
        self.device = device
        self.batch_size = batch_size
        self.frame_size = frame_size
        self.dtype = dtype
        self.pinned = device.type == "cuda"
        self.depth = 2 if self.pinned else 1
        self._slots: Dict[int, list] = {}
        self._turn: Dict[int, int] = {}

    def _new_slot(self, bucket: int):
        B, fs = self.batch_size, self.frame_size
        frames = torch.empty((B, bucket, fs, fs, 3), dtype=self.dtype,
                             pin_memory=self.pinned)
        mask = torch.empty((B, bucket), dtype=torch.bool, pin_memory=self.pinned)
        copied = torch.cuda.Event() if self.pinned else None
        return frames, mask, copied

    def stage(self, bucket: int, clips: Sequence[np.ndarray]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad `clips` into a (B, bucket, H, W, 3) batch of the staging dtype
        and a (B, bucket) mask on the device; rows past len(clips) are zero
        with an all-False mask."""
        slots = self._slots.setdefault(bucket, [])
        turn = self._turn.get(bucket, 0)
        self._turn[bucket] = turn + 1
        if len(slots) < self.depth:
            slots.append(self._new_slot(bucket))
        frames, mask, copied = slots[turn % self.depth]
        if copied is not None:
            with trace.span("embed.slot_wait"):
                copied.synchronize()  # the slot's previous copy has left it
        f, m = frames.numpy(), mask.numpy()
        rows = range(self.batch_size)
        with trace.span("embed.fill"):
            if f.nbytes >= STAGE_POOL_MIN_BYTES:
                # list() waits for every row and re-raises a worker's exception
                list(_stage_pool().map(lambda i: _fill_row(f, m, clips, i), rows))
                trace.count("embed.fill_pooled")
            else:
                for i in rows:
                    _fill_row(f, m, clips, i)
        trace.count("embed.frames_staged", self.batch_size * bucket)
        trace.count("embed.frames_useful", sum(clip.shape[0] for clip in clips))
        frames_dev = frames.to(self.device, non_blocking=True)
        mask_dev = mask.to(self.device, non_blocking=True)
        if copied is not None:
            copied.record(torch.cuda.current_stream(self.device))
        return frames_dev, mask_dev


class FingerprintScanner:
    """Extract fingerprints and find duplicate videos.

    device: "cuda" (default; raises without a card) or "cpu". bf16=False
    computes in float32 with TF32 off for cuDNN convolutions and cuBLAS
    matmuls; bf16=True casts the model to bfloat16. optimize folds eval
    BatchNorm into the convs (lossless). The model family, its widths and
    the 3D model's clip_length (default 128) and frame_stride (default 32)
    come from the checkpoint's config. native_decode and native_preprocess
    select the native host paths (utils/native_decode.py, utils/native.py);
    where a library cannot be built the scanner says so, as the JAX
    package's does, and decodes with cv2.

    data_parallel (JAX scanner.py:172-213): True shards the batched
    extraction over every device of `device`'s platform, or over the given
    device list (which may repeat a device). One process holds a replica of
    the folded model on each device; batch_size is padded to a multiple of
    the device count and each batch is split on video (window) boundaries,
    each device staging its part in its own buffers; the replicas' forwards
    are launched in turn, so they overlap on separate cards, and their
    embeddings are joined on the host. With one device on the platform it
    runs there and says so. The single-video and sequential paths stay on
    `device`. `devices` (the given list, else the platform's) is also what
    the top-k duplicate search shards over where ops/topk.py::shard_search
    says so (at least 8 videos a shard). Under a process group of several
    ranks the default list is the rank's own `device`, and the search's
    shards are every rank's devices: each rank passes the same embeddings
    and gets the same duplicate groups, so every rank must run the search
    (a call on one rank alone waits for the others).
    """

    def __init__(
        self,
        model_path: str,
        device: str = "cuda",
        batch_size: int = 8,
        buckets: Optional[Sequence[int]] = None,
        native_preprocess: bool = False,
        native_decode: bool = False,
        bf16: bool = False,
        optimize: bool = True,
        data_parallel: bool | Sequence = False,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.devices = as_devices(None if isinstance(data_parallel, bool) else data_parallel,
                                    self.device)
        self.native_preprocess = False
        if native_preprocess:
            self.native_preprocess = native.available()
            if not self.native_preprocess:
                print("native preprocess requested but unavailable; using cv2")
        self.native_decode = False
        if native_decode:
            self.native_decode = native_decode_lib.available()
            if not self.native_decode:
                print("native decode requested but unavailable; using cv2")

        print(f"Loading model from {model_path}...")
        self.variables, self.config = load_any(model_path)
        self.model_type = self.config.get("model_type", "attention")
        if self.model_type not in MODEL_TYPES:
            raise ValueError(f"Unknown model type: {self.model_type}")
        self.is_3d = self.model_type != "attention"
        # identity of the embedding space: config + a hash of the raw
        # checkpoint arrays, equal to the JAX scanner's for the same file
        param_hash = _hash_variables(self.variables)
        self.frame_size = self.config.get("frame_size", 64)
        self.max_frames = self.config.get("max_frames", 500)
        self.embedding_dim = self.config.get("embedding_dim", 256)
        self.clip_length = self.config.get("clip_length", 128)
        self.frame_stride = self.config.get("frame_stride", 32)
        self.model_identity = {
            "model_type": self.model_type,
            "embedding_dim": self.embedding_dim,
            "frame_size": self.frame_size,
            "max_frames": self.max_frames,
            "param_hash": param_hash,
        }

        # Lossless inference fusion: eval BN folded into the conv weights.
        self.fused = bool(optimize)
        sd = variables_to_state_dict(self.variables, self.model_type)
        if self.fused:
            sd = fuse_state_dict(sd, self.model_type)
        self.model = create_model(
            self.model_type,
            spatial_dim=self.config.get("spatial_dim", 128),
            temporal_dim=self.config.get("temporal_dim", 256),
            embedding_dim=self.embedding_dim,
            num_attention_blocks=self.config.get("num_attention_blocks", 4),
            frame_stride=self.frame_stride,
            fused=self.fused,
        )
        self.model.load_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
        self.model.to(device=self.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32).eval()
        if self.device.type == "cuda":  # the layouts cuDNN takes directly
            if self.is_3d:
                self.model.encoder.to(memory_format=torch.channels_last_3d)
            else:
                self.model.spatial_encoder.to(memory_format=torch.channels_last)

        self.buckets = tuple(
            b for b in (buckets or SCAN_BUCKETS) if b < self.max_frames
        ) + (self.max_frames,)
        # float32 only from the native preprocess path (the attention
        # producer without native decode); uint8 from cv2 and native decode
        self.stage_dtype = (np.float32 if (self.native_preprocess and not self.native_decode
                                           and not self.is_3d) else np.uint8)
        shard_devices = self.devices if data_parallel else [self.device]
        self.batch_size = pad_to_multiple(batch_size, len(shard_devices))
        # a replica of the model on each other device; the shards' staging
        # buffers, in the order the batch rows are split
        self._replicas = {dev: copy.deepcopy(self.model).to(dev)
                          for dev in set(shard_devices) - {self.device}}
        stage_dtype = torch.float32 if self.stage_dtype == np.float32 else torch.uint8
        per_shard = self.batch_size // len(shard_devices)
        self._shards = [_Staging(dev, per_shard, self.frame_size, stage_dtype)
                        for dev in shard_devices]
        if data_parallel and len(shard_devices) > 1:
            print(f"Data-parallel extraction over {len(shard_devices)} devices "
                  f"(batch {self.batch_size})")
        elif data_parallel:
            print(f"Data-parallel extraction: one device on the platform, running on "
                  f"{shard_devices[0]}")
        print(f"Model loaded - Type: {self.model_type}, Device: {self.device}")

    @contextmanager
    def _inference(self):
        with torch.inference_mode(), full_fp32():
            yield

    def warmup(self, num_frames: Optional[int] = None) -> None:
        """Run the batched forward once per bucket the scan may use, so the
        kernel build and cuDNN's plans happen before the scan: every bucket
        when num_frames is None, else the bucket of num_frames (attention),
        or clip_length plus the stride-multiple bucket of a shorter
        num_frames (3D)."""
        fs = self.frame_size
        if self.is_3d:
            lengths = {self.clip_length}
            if num_frames is not None and num_frames < self.clip_length:
                lengths.add(self._3d_bucket(max(MIN_FRAMES, num_frames)))
        elif num_frames is None:
            lengths = set(self.buckets)
        else:
            lengths = {preprocess.bucket_for_length(min(num_frames, self.max_frames),
                                                    self.buckets)}
        for length in sorted(lengths):
            for staging in self._shards:
                B = staging.batch_size
                frames = torch.zeros((B, length, fs, fs, 3), dtype=staging.dtype,
                                     device=staging.device)
                mask = torch.zeros((B, length), dtype=torch.bool, device=staging.device)
                mask[:, 0] = True
                with self._inference():
                    self._forward_batch(frames, mask)
        for staging in self._shards:
            if staging.device.type == "cuda":
                torch.cuda.synchronize(staging.device)

    def _forward_batch(self, frames: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) staged batch and its (B, T) mask -> (B, D), by the
        model (or replica) on the batch's device."""
        model = self._replicas.get(frames.device, self.model)
        if self.is_3d:  # stride-multiple buckets: the zero padding is the model's own
            return model(frames)
        return model.forward_flat(frames.view((-1,) + tuple(frames.shape[2:])),
                                  frames.shape[0], mask)

    # ------------------------------------------------------------------
    # Single-video extraction (reference fingerprint.py:216-320)
    # ------------------------------------------------------------------

    def _embed_flat(self, flat: np.ndarray, batch_size: int) -> np.ndarray:
        x = torch.from_numpy(flat).to(self.device)
        with self._inference():
            return self.model.forward_flat(x, batch_size).cpu().numpy()

    def extract_fingerprint(self, video_path: Path, num_segments: int = 3
                            ) -> Optional[np.ndarray]:
        """One video, unbatched: its embedding, or None when it decodes to
        (attention) or has (3D) fewer than 10 frames."""
        if self.is_3d:
            return self._extract_3d(Path(video_path))
        frames = decode.decode_subsampled(video_path, self.max_frames)
        if len(frames) < MIN_FRAMES:
            print(f"Video too short: {video_path} ({len(frames)} frames)")
            return None

        if len(frames) <= self.max_frames:
            clip = preprocess.preprocess_frames(frames, self.frame_size)
            return self._embed_flat(clip, 1)[0]

        # Evenly spaced segments averaged WITHOUT renormalizing: the
        # reference's behaviour for the attention path (fingerprint.py:
        # 251-270), kept as it is. The segments share one length, so they
        # go through one batched forward.
        segment_length = min(self.max_frames, len(frames) // num_segments)
        clips = []
        for i in range(num_segments):
            start = (
                i * (len(frames) - segment_length) // (num_segments - 1)
                if num_segments > 1
                else 0
            )
            seg = frames[start : start + segment_length]
            clips.append(preprocess.preprocess_frames(seg, self.frame_size))
        stacked = np.stack(clips)
        embeddings = self._embed_flat(
            stacked.reshape((-1,) + stacked.shape[2:]), len(clips))
        return np.mean(embeddings, axis=0)

    def window_plan(self, total_frames: int) -> List[Tuple[int, int]]:
        """3D windows (start, length) of a video of total_frames frames: one
        window of the whole video up to clip_length frames, else
        min(5, max(3, total // (2 * clip_length))) evenly strided windows of
        clip_length frames (fingerprint.py:293-318)."""
        L = self.clip_length
        if total_frames <= L:
            return [(0, total_frames)]
        n = min(5, max(3, total_frames // (L * 2)))
        stride = (total_frames - L) // (n - 1)
        return [(i * stride, L) for i in range(n)]

    def _3d_bucket(self, num_frames: int) -> int:
        """Padded length of a 3D clip: the next multiple of frame_stride,
        capped at clip_length. The model zero-pads time to that multiple
        anyway (models/cnn3d.py), so a clip padded there embeds as its own
        length does, and short videos share batches."""
        stride = max(1, self.frame_stride)
        return min(self.clip_length, -(-num_frames // stride) * stride)

    def _window_clip(self, video_path: Path, start: int, length: int,
                     normalize: bool) -> np.ndarray:
        frames = decode.decode_clip(video_path, start, length)
        frames = [preprocess.square_center_crop_resize(f, self.frame_size)
                  for f in frames]
        return (preprocess.frames_to_clip(frames) if normalize
                else preprocess.frames_to_clip_u8(frames))

    def _extract_3d(self, video_path: Path) -> Optional[np.ndarray]:
        """One video through the 3D model window by window (batch 1, float
        clips normalized on the host)."""
        info = decode.probe(video_path)
        if not info or info.total_frames < MIN_FRAMES:
            return None
        windows = self.window_plan(info.total_frames)
        embs = []
        for start, length in windows:
            clip = torch.from_numpy(self._window_clip(video_path, start, length, True))
            with self._inference():
                embs.append(self.model(clip[None].to(self.device)).cpu().numpy()[0])
        return reduce_windows(embs, len(windows))

    # ------------------------------------------------------------------
    # Directory scan (reference fingerprint.py:322-448)
    # ------------------------------------------------------------------

    def scan_directory(
        self,
        directory: Path,
        extensions: Optional[List[str]] = None,
        num_workers: int = 4,
        batched: bool = True,
        cache: Optional[Dict[str, dict]] = None,
    ) -> Dict[str, dict]:
        """{path: fingerprint} for every video under `directory`. With a
        `cache` ({path: fingerprint} of an earlier scan), a file whose size
        and md5 of the first MiB match its entry keeps that entry and is not
        decoded; the hits are merged into the result."""
        directory = Path(directory)
        extensions = extensions or DEFAULT_EXTENSIONS
        video_paths: List[Path] = []
        for ext in extensions:
            video_paths.extend(directory.glob(f"**/*{ext}"))
            video_paths.extend(directory.glob(f"**/*{ext.upper()}"))
        video_paths = sorted(set(video_paths))
        print(f"\n{len(video_paths)} videos found in {directory}")

        cached_hits: Dict[str, dict] = {}
        if cache:
            remaining: List[Path] = []
            for p in video_paths:
                entry = cache.get(str(p))
                try:
                    hit = (entry is not None
                           and p.stat().st_size == entry.get("size")
                           and compute_file_hash(p, max_bytes=1024 * 1024)
                           == entry.get("file_hash"))
                except OSError:  # gone since the glob: the scan counts it as a failure
                    hit = False
                if hit:
                    cached_hits[str(p)] = entry
                else:
                    remaining.append(p)
            print(f"{len(cached_hits)} unchanged (index hit), {len(remaining)} to scan")
            video_paths = remaining

        start = time.time()
        if batched and self.is_3d:
            fingerprints, failed = self._scan_batched_3d(video_paths, num_workers)
        elif batched:
            fingerprints, failed = self._scan_batched(video_paths, num_workers)
        else:
            fingerprints, failed = self._scan_sequential(video_paths)
        elapsed = time.time() - start
        if video_paths:
            print(
                f"Processed {len(fingerprints)} videos in {elapsed:.1f}s "
                f"({len(fingerprints) / max(elapsed, 1e-9):.2f} videos/s, "
                f"{failed} failures)"
            )
        fingerprints.update(cached_hits)
        return fingerprints

    def _metadata(self, video_path: Path, embedding: np.ndarray) -> dict:
        return {
            "embedding": embedding,
            "path": str(video_path),
            "name": video_path.name,
            "size": video_path.stat().st_size,
            "file_hash": compute_file_hash(video_path, max_bytes=1024 * 1024),
            "embedding_norm": float(np.linalg.norm(embedding)),
        }

    def _scan_sequential(self, video_paths: List[Path]):
        fingerprints: Dict[str, dict] = {}
        failed = 0
        for video_path in video_paths:
            emb = self.extract_fingerprint(video_path)
            if emb is None:
                failed += 1
                continue
            fingerprints[str(video_path)] = self._metadata(video_path, emb)
        return fingerprints, failed

    def _scan_batched(self, video_paths: List[Path], num_workers: int):
        """Decode producer -> batching stage -> per-file metadata."""
        embeddings = self.embed_clips((path, clip) for path, clip
                                      in self.decode_clips(video_paths, num_workers)
                                      if clip is not None)
        fingerprints = {str(p): self._metadata(p, e) for p, e in embeddings.items()}
        return fingerprints, len(video_paths) - len(embeddings)

    def _scan_batched_3d(self, video_paths: List[Path], num_workers: int):
        """Window planner -> decode producer -> batching stage -> one
        embedding per video. A video fails when it cannot be probed, has
        fewer than 10 frames, or none of its windows decoded; otherwise it
        reduces over the windows that did."""
        plans = self.plan_windows(video_paths, num_workers)
        embeddings = self.embed_clips(self.decode_windows(plans, num_workers))
        fingerprints: Dict[str, dict] = {}
        for path, windows in plans:
            embs = [embeddings[(path, i)] for i in range(len(windows or ()))
                    if (path, i) in embeddings]
            if embs:
                emb = reduce_windows(embs, len(windows))
                fingerprints[str(path)] = self._metadata(path, emb)
        return fingerprints, len(plans) - len(fingerprints)

    def plan_windows(self, video_paths: Sequence[Path], num_workers: int
                     ) -> List[Tuple[Path, Optional[List[Tuple[int, int]]]]]:
        """(path, windows) per video, probed by a pool of host threads;
        windows is None for a video that cannot be probed or has fewer than
        10 frames."""
        def plan(path):
            info = decode.probe(path)
            if not info or info.total_frames < MIN_FRAMES:
                return path, None
            return path, self.window_plan(info.total_frames)

        with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
            return list(pool.map(plan, video_paths))

    def decode_windows(self, plans, num_workers: int
                       ) -> Iterator[Tuple[Tuple[Path, int], np.ndarray]]:
        """Decode producer of the 3D scan: ((path, window index), (T, H, W, 3)
        uint8 clip) in plan order, decoded by `_decode_ahead`. A window that
        fails to decode is left out."""
        jobs = [((path, i), start, length) for path, windows in plans if windows
                for i, (start, length) in enumerate(windows)]

        def load(job):
            (path, _), start, length = job
            try:
                if self.native_decode:
                    return native_decode_lib.decode_clip(path, start, length,
                                                         self.frame_size)
                return self._window_clip(path, start, length, normalize=False)
            except Exception:  # one unreadable window must not end the scan
                return None

        with closing(_decode_ahead(jobs, load, num_workers)) as clips:
            yield from ((key, clip) for (key, _, _), clip in clips if clip is not None)

    def decode_clips(self, video_paths: Sequence[Path], num_workers: int
                     ) -> Iterator[Tuple[Path, Optional[np.ndarray]]]:
        """Decode producer: paths -> (path, (T, H, W, 3) clip of the staging
        dtype), in path order, decoded by `_decode_ahead`. A file that fails
        to decode or has fewer than 10 frames gives (path, None)."""
        def load(path):
            try:
                if self.native_decode:  # fused demux->decode->scale->crop
                    clip = native_decode_lib.decode_scan(path, self.max_frames,
                                                         self.frame_size)
                    return None if clip is None or clip.shape[0] < MIN_FRAMES else clip
                frames = decode.decode_subsampled(path, self.max_frames)
                if len(frames) < MIN_FRAMES:
                    return None
                if self.native_preprocess:
                    return native.preprocess_frames(np.stack(frames), self.frame_size)
                return preprocess.preprocess_frames(frames, self.frame_size,
                                                    normalize=False)
            except Exception:  # one unreadable file must not end the scan
                return None

        yield from _decode_ahead(video_paths, load, num_workers)

    def embed_clips(self, clips: Iterable[Tuple[Hashable, np.ndarray]]
                    ) -> Dict[Hashable, np.ndarray]:
        """Batching stage: (key, (T, H, W, 3) clip) pairs -> {key: embedding},
        in the order the batches complete. Clips are uint8, or float32 in
        [0, 1] when the scanner stages float32 (`stage_dtype`: native
        preprocess). T is 1..max_frames (attention) or 1..clip_length (3D).

        Clips are grouped by length bucket (the scan buckets, or the 3D
        model's stride multiples); a bucket's batch is forwarded when it
        holds batch_size clips, and every partial batch at the end. Under
        data_parallel each shard forwards its consecutive batch_size / d
        rows of the batch (a partial batch's padding rows included)."""
        pending: Dict[int, list] = {}
        out: Dict[Hashable, np.ndarray] = {}
        shape = (self.frame_size, self.frame_size, 3)
        limit = self.clip_length if self.is_3d else self.max_frames

        def on_result(items, embs):
            for i, (key, _) in enumerate(items):
                out[key] = embs[i]

        pipeline = _AsyncPipeline(on_result)

        def flush(bucket: int):
            request = trace.new_request()
            with trace.span("embed.batch", request):
                items = pending.pop(bucket)
                clips = [clip for _, clip in items]
                readbacks = []
                with self._inference():
                    for staging in self._shards:
                        lo = len(readbacks) * staging.batch_size
                        frames, mask = staging.stage(bucket,
                                                     clips[lo:lo + staging.batch_size])
                        with trace.span("embed.forward"):
                            readbacks.append(_Readback(self._forward_batch(frames, mask)))
                pipeline.dispatch(items, _Gathered(readbacks), request)

        for key, clip in clips:
            if clip.dtype != self.stage_dtype or clip.shape[1:] != shape:
                raise ValueError(f"clip {key!r}: expected (T, {shape[0]}, {shape[1]}, "
                                 f"3) {np.dtype(self.stage_dtype).name}, got {clip.shape} "
                                 f"{clip.dtype}")
            if not 1 <= clip.shape[0] <= limit:
                raise ValueError(f"clip {key!r}: {clip.shape[0]} frames, expected "
                                 f"1..{limit}")
            bucket = (self._3d_bucket(clip.shape[0]) if self.is_3d
                      else preprocess.bucket_for_length(clip.shape[0], self.buckets))
            pending.setdefault(bucket, []).append((key, clip))
            if len(pending[bucket]) >= self.batch_size:
                flush(bucket)
        for bucket in sorted(pending):
            flush(bucket)
        pipeline.finish()
        return out

    # ------------------------------------------------------------------
    # Duplicate search (reference fingerprint.py:450-548)
    # ------------------------------------------------------------------

    def find_duplicates(
        self,
        fingerprints: Dict[str, dict],
        similarity_threshold: float = 0.95,
        topk_threshold: int = 100,
        use_faiss: bool = True,
    ) -> List[List[dict]]:
        """Greedy duplicate groups: from the full similarity matrix up to
        `topk_threshold` videos, from exact top-k candidates above it.
        use_faiss is the reference's name (fingerprint.py:454) for the top-k
        route; False forces the full matrix."""
        if not use_faiss:
            topk_threshold = 1 << 60
        if len(fingerprints) < 2:
            return []

        print(f"\nSearching for duplicates (threshold: {similarity_threshold})...")
        paths = list(fingerprints.keys())
        embeddings = np.stack(
            [np.asarray(fingerprints[p]["embedding"], dtype=np.float32) for p in paths]
        )
        route = (self._find_duplicates_topk if len(embeddings) > topk_threshold
                 else self._find_duplicates_direct)
        return dedup.tag_exact_duplicates(
            route(embeddings, paths, fingerprints, similarity_threshold))

    def _similarities_full(self, embeddings: np.ndarray) -> np.ndarray:
        e = torch.from_numpy(embeddings).to(self.device)
        with full_fp32():
            return (e @ e.T).cpu().numpy()

    def _find_duplicates_direct(self, embeddings, paths, fingerprints, threshold):
        """All-pairs matrix + greedy grouping (fingerprint.py:482-513)."""
        return dedup.library_groups(self._similarities_full(embeddings), None, threshold,
                                    paths, fingerprints)

    def _find_duplicates_topk(self, embeddings, paths, fingerprints, threshold):
        """k-NN candidates from exact top-k + the greedy grouping the
        reference applies to its FAISS results (fingerprint.py:515-548)."""
        n = len(embeddings)
        if shard_search(n, self.devices):  # the corpus-sharded ring
            sims, idx = sharded_topk_cosine(embeddings, min(20, n), devices=self.devices,
                                            exact_above=threshold)
        else:
            sims, idx = topk_cosine(torch.from_numpy(embeddings).to(self.device), min(20, n),
                                    exact_above=threshold)
        return dedup.library_groups(sims.cpu().numpy(), idx.cpu().numpy(), threshold,
                                    paths, fingerprints)

    def find_duplicates_against(
        self,
        fingerprints: Dict[str, dict],
        index,
        similarity_threshold: float = 0.95,
        k: int = 20,
    ) -> List[List[dict]]:
        """Query-vs-corpus search: each scanned video is searched against a
        saved `FingerprintIndex` and reported as a group [query, matching
        corpus entries...] when any entry clears the threshold. A corpus
        entry with the query's own path is skipped. Raises ValueError for
        an index of another model or embedding dimension."""
        with trace.span("against.call", trace.new_request()):
            with trace.span("against.prepare"):
                if not fingerprints or len(index) == 0:
                    return []
                reason = identity_mismatch(index.model_identity, self.model_identity)
                if reason:
                    raise ValueError(
                        f"corpus index was built by a different model ({reason}); "
                        f"its embeddings are not comparable with this checkpoint's")
                if index.dim != self.embedding_dim:
                    raise ValueError(f"corpus index embedding dim {index.dim} != model "
                                     f"embedding dim {self.embedding_dim}")
                paths = list(fingerprints.keys())
                queries = np.stack([np.asarray(fingerprints[p]["embedding"], np.float32)
                                    for p in paths])
            sims, idx = index.search(queries, k=k, exact_above=similarity_threshold)
            with trace.span("against.group"):
                return dedup.against_groups(sims, idx, similarity_threshold, paths,
                                            fingerprints, index.meta)


def reduce_windows(embeddings: Sequence[np.ndarray], num_windows: int) -> np.ndarray:
    """One 3D video's embedding from its windows': a single-window video's
    as the model gave it (already unit norm), else the mean over the windows
    that decoded, renormalized (fingerprint.py:300-318). The attention path
    averages its segments without renormalizing; both rules are the
    reference's. Each call is one `scan.reduce_windows` span and counts
    its windows (`scan.windows_reduced`) and its video
    (`scan.videos_reduced`)."""
    with trace.span("scan.reduce_windows"):
        trace.count("scan.windows_reduced", len(embeddings))
        trace.count("scan.videos_reduced")
        if num_windows == 1:
            return np.asarray(embeddings[0])
        mean = np.mean(np.stack(embeddings), axis=0)
        return mean / np.linalg.norm(mean)


def _hash_variables(variables) -> str:
    """md5 over every array leaf of a variables tree in sorted key-path
    order. Paths are spelled as jax.tree_util.keystr spells them
    (['params']['spatial_encoder']...), so the hash equals the JAX
    scanner's for the same checkpoint."""
    leaves = []

    def walk(node, path):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, f"{path}[{key!r}]")
        else:
            leaves.append((path, node))

    walk(variables, "")
    md5 = hashlib.md5()
    for path, leaf in sorted(leaves, key=lambda kv: kv[0]):
        md5.update(path.encode())
        md5.update(np.ascontiguousarray(leaf).tobytes())
    return md5.hexdigest()


def compute_file_hash(file_path: Path, max_bytes: Optional[int] = None) -> str:
    """MD5 of the file (or its first `max_bytes`) — fingerprint.py:436-448."""
    md5 = hashlib.md5()
    with open(file_path, "rb") as f:
        if max_bytes:
            md5.update(f.read(max_bytes))
        else:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                md5.update(chunk)
    return md5.hexdigest()
