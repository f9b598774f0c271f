"""Fingerprint scanner: directory scan -> embeddings -> duplicate groups.

Port of video_fingerprint_tpu/inference/scanner.py for the attention model:

  - the checkpoint (`.ckpt` or reference `.pth`) loads, BatchNorm folds into
    the convs (on by default), and the model is rebuilt from the embedded
    config;
  - a decode producer turns paths into uint8 clips on host threads;
  - the batching stage pads each clip to a length bucket, masks the padding
    and forwards fixed-shape batches; partial batches are padded with rows
    whose mask is all False. Staging buffers are pinned, the copies to and
    from the card are asynchronous, and one batch's result is read back
    only after the next batch is on its way;
  - duplicates are grouped from the full similarity matrix (up to 100
    videos) or from exact top-k candidates.

Entry points run on the card (device="cuda") unless the caller asks for the
CPU. In float32 mode every forward and similarity runs with TF32 off for
cuDNN convolutions and cuBLAS matmuls, so embeddings hold the JAX
package's f32 results.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Hashable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_fingerprint_tpu_torch.data import decode, preprocess
from video_fingerprint_tpu_torch.models import create_model
from video_fingerprint_tpu_torch.models.fuse import fuse_state_dict
from video_fingerprint_tpu_torch.ops.topk import topk_cosine
from video_fingerprint_tpu_torch.training.checkpoint import load_any
from video_fingerprint_tpu_torch.utils.precision import full_fp32
from video_fingerprint_tpu_torch.utils.torch_compat import (
    attention_variables_to_state_dict,
)

DEFAULT_EXTENSIONS = [".mp4", ".avi", ".mov", ".mkv", ".webm", ".flv"]
SCAN_BUCKETS = (32, 64, 128, 256, 512)
MIN_FRAMES = 10  # reference minimum (fingerprint.py:238-240)


def resolve_device(device: str | torch.device) -> torch.device:
    """torch.device for "cuda" or "cpu"; "cuda" without a card raises."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    return dev


class _Readback:
    """A device result on its way to the host: on CUDA an asynchronous copy
    into pinned memory, completed by `wait()`."""

    def __init__(self, result: torch.Tensor):
        self._done = None
        if result.is_cuda:
            self._host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
            self._host.copy_(result, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host = result

    def wait(self) -> np.ndarray:
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


class _AsyncPipeline:
    """One-deep dispatch/readback pipeline: the previous batch's result is
    read back only after the next batch has been dispatched, overlapping
    the copies and compute of one batch with the readback of the other."""

    def __init__(self, on_result):
        self._inflight: List[Tuple[Any, _Readback]] = []
        self._on_result = on_result

    def dispatch(self, context, readback: _Readback) -> None:
        self._inflight.append((context, readback))
        while len(self._inflight) > 1:
            self._drain_one()

    def _drain_one(self) -> None:
        context, readback = self._inflight.pop(0)
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

    def __init__(self, device: torch.device, batch_size: int, frame_size: int):
        self.device = device
        self.batch_size = batch_size
        self.frame_size = frame_size
        self.pinned = device.type == "cuda"
        self.depth = 2 if self.pinned else 1
        self._slots: Dict[int, list] = {}
        self._turn: Dict[int, int] = {}

    def _new_slot(self, bucket: int):
        B, fs = self.batch_size, self.frame_size
        frames = torch.empty((B, bucket, fs, fs, 3), dtype=torch.uint8,
                             pin_memory=self.pinned)
        mask = torch.empty((B, bucket), dtype=torch.bool, pin_memory=self.pinned)
        copied = torch.cuda.Event() if self.pinned else None
        return frames, mask, copied

    def stage(self, bucket: int, clips: Sequence[np.ndarray]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pad `clips` into a (B*bucket, H, W, 3) uint8 batch and a (B, bucket)
        mask on the device; rows past len(clips) are zero with an all-False
        mask."""
        slots = self._slots.setdefault(bucket, [])
        turn = self._turn.get(bucket, 0)
        self._turn[bucket] = turn + 1
        if len(slots) < self.depth:
            slots.append(self._new_slot(bucket))
        frames, mask, copied = slots[turn % self.depth]
        if copied is not None:
            copied.synchronize()  # the slot's previous copy has left it
        f, m = frames.numpy(), mask.numpy()
        m[:] = False
        for i, clip in enumerate(clips):
            t = clip.shape[0]
            f[i, :t] = clip
            f[i, t:] = 0
            m[i, :t] = True
        f[len(clips):] = 0
        frames_dev = frames.to(self.device, non_blocking=True)
        mask_dev = mask.to(self.device, non_blocking=True)
        if copied is not None:
            copied.record()
        return frames_dev.view((-1,) + tuple(frames.shape[2:])), mask_dev


class FingerprintScanner:
    """Extract fingerprints and find duplicate videos.

    device: "cuda" (default; raises without a card) or "cpu". bf16=False
    computes in float32 with TF32 off for cuDNN convolutions and cuBLAS
    matmuls; bf16=True casts the model to bfloat16. optimize folds eval
    BatchNorm into the convs (lossless).
    """

    def __init__(
        self,
        model_path: str,
        device: str = "cuda",
        batch_size: int = 8,
        buckets: Optional[Sequence[int]] = None,
        bf16: bool = False,
        optimize: bool = True,
    ):
        self.batch_size = batch_size
        self.device = resolve_device(device)

        print(f"Loading model from {model_path}...")
        self.variables, self.config = load_any(model_path)
        self.model_type = self.config.get("model_type", "attention")
        if self.model_type != "attention":
            raise NotImplementedError(
                f"model_type {self.model_type!r} is not ported yet "
                "(ROADMAP.md, module item 7)")
        # identity of the embedding space: config + a hash of the raw
        # checkpoint arrays, equal to the JAX scanner's for the same file
        param_hash = _hash_variables(self.variables)
        self.frame_size = self.config.get("frame_size", 64)
        self.max_frames = self.config.get("max_frames", 500)
        self.embedding_dim = self.config.get("embedding_dim", 256)
        self.model_identity = {
            "model_type": self.model_type,
            "embedding_dim": self.embedding_dim,
            "frame_size": self.frame_size,
            "max_frames": self.max_frames,
            "param_hash": param_hash,
        }

        # Lossless inference fusion: eval BN folded into the conv weights.
        self.fused = bool(optimize)
        sd = attention_variables_to_state_dict(self.variables)
        if self.fused:
            sd = fuse_state_dict(sd)
        self.model = create_model(
            self.model_type,
            spatial_dim=self.config.get("spatial_dim", 128),
            temporal_dim=self.config.get("temporal_dim", 256),
            embedding_dim=self.embedding_dim,
            num_attention_blocks=self.config.get("num_attention_blocks", 4),
            fused=self.fused,
        )
        self.model.load_state_dict(
            {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
        self.model.to(device=self.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32).eval()
        if self.device.type == "cuda":
            self.model.spatial_encoder.to(memory_format=torch.channels_last)

        self.buckets = tuple(
            b for b in (buckets or SCAN_BUCKETS) if b < self.max_frames
        ) + (self.max_frames,)
        self._staging = _Staging(self.device, batch_size, self.frame_size)
        print(f"Model loaded - Type: {self.model_type}, Device: {self.device}")

    @contextmanager
    def _inference(self):
        with torch.inference_mode(), full_fp32():
            yield

    def warmup(self) -> None:
        """Run the batched forward once per bucket, so the kernel build and
        cuDNN's plans happen before the scan."""
        B, fs = self.batch_size, self.frame_size
        for bucket in self.buckets:
            frames = torch.zeros((B * bucket, fs, fs, 3), dtype=torch.uint8,
                                 device=self.device)
            mask = torch.zeros((B, bucket), dtype=torch.bool, device=self.device)
            mask[:, 0] = True
            with self._inference():
                self.model.forward_flat(frames, B, mask)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        fewer than 10 frames."""
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

    # ------------------------------------------------------------------
    # Directory scan (reference fingerprint.py:322-448)
    # ------------------------------------------------------------------

    def scan_directory(
        self,
        directory: Path,
        extensions: Optional[List[str]] = None,
        num_workers: int = 4,
        batched: bool = True,
    ) -> Dict[str, dict]:
        directory = Path(directory)
        extensions = extensions or DEFAULT_EXTENSIONS
        video_paths: List[Path] = []
        for ext in extensions:
            video_paths.extend(directory.glob(f"**/*{ext}"))
            video_paths.extend(directory.glob(f"**/*{ext.upper()}"))
        video_paths = sorted(set(video_paths))
        print(f"\n{len(video_paths)} videos found in {directory}")

        start = time.time()
        if batched:
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
        failed = 0

        def decoded():
            nonlocal failed
            for path, clip in self.decode_clips(video_paths, num_workers):
                if clip is None:
                    failed += 1
                else:
                    yield path, clip

        embeddings = self.embed_clips(decoded())
        fingerprints = {str(p): self._metadata(p, e) for p, e in embeddings.items()}
        return fingerprints, failed

    def decode_clips(self, video_paths: Sequence[Path], num_workers: int
                     ) -> Iterator[Tuple[Path, Optional[np.ndarray]]]:
        """Decode producer: paths -> (path, (T, H, W, 3) uint8 clip), in path
        order, decoded by a pool of host threads. A file that fails to decode
        or has fewer than 10 frames gives (path, None)."""
        work: "queue.Queue" = queue.Queue(maxsize=max(1, num_workers) * 4)
        done = object()

        def load(path):
            try:
                frames = decode.decode_subsampled(path, self.max_frames)
                if len(frames) < MIN_FRAMES:
                    return path, None
                return path, preprocess.preprocess_frames(
                    frames, self.frame_size, normalize=False)
            except Exception:  # one unreadable file must not end the scan
                return path, None

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
                    for item in pool.map(load, video_paths):
                        work.put(item)
            finally:
                work.put(done)

        threading.Thread(target=producer, daemon=True).start()
        while (item := work.get()) is not done:
            yield item

    def embed_clips(self, clips: Iterable[Tuple[Hashable, np.ndarray]]
                    ) -> Dict[Hashable, np.ndarray]:
        """Batching stage: (key, (T, H, W, 3) uint8 clip) pairs -> {key:
        embedding}, in the order the batches complete.

        Clips are grouped by length bucket; a bucket's batch is forwarded when
        it holds batch_size clips, and every partial batch at the end."""
        pending: Dict[int, list] = {b: [] for b in self.buckets}
        out: Dict[Hashable, np.ndarray] = {}
        shape = (self.frame_size, self.frame_size, 3)

        def on_result(items, embs):
            for i, (key, _) in enumerate(items):
                out[key] = embs[i]

        pipeline = _AsyncPipeline(on_result)

        def flush(bucket: int):
            items = pending[bucket]
            if not items:
                return
            frames, mask = self._staging.stage(bucket, [clip for _, clip in items])
            with self._inference():
                embs = self.model.forward_flat(frames, self.batch_size, mask)
                pipeline.dispatch(items, _Readback(embs))
            pending[bucket] = []

        for key, clip in clips:
            if clip.dtype != np.uint8 or clip.shape[1:] != shape:
                raise ValueError(f"clip {key!r}: expected (T, {shape[0]}, {shape[1]}, "
                                 f"3) uint8, got {clip.shape} {clip.dtype}")
            if not 1 <= clip.shape[0] <= self.max_frames:
                raise ValueError(f"clip {key!r}: {clip.shape[0]} frames, expected "
                                 f"1..{self.max_frames}")
            bucket = preprocess.bucket_for_length(clip.shape[0], self.buckets)
            pending[bucket].append((key, clip))
            if len(pending[bucket]) >= self.batch_size:
                flush(bucket)
        for bucket in self.buckets:
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
    ) -> List[List[dict]]:
        """Greedy duplicate groups: from the full similarity matrix up to
        `topk_threshold` videos, from exact top-k candidates above it."""
        if len(fingerprints) < 2:
            return []

        print(f"\nSearching for duplicates (threshold: {similarity_threshold})...")
        paths = list(fingerprints.keys())
        embeddings = np.stack(
            [np.asarray(fingerprints[p]["embedding"], dtype=np.float32) for p in paths]
        )
        if len(embeddings) > topk_threshold:
            groups = self._find_duplicates_topk(
                embeddings, paths, fingerprints, similarity_threshold)
        else:
            groups = self._find_duplicates_direct(
                embeddings, paths, fingerprints, similarity_threshold)

        # exact-duplicate tagging via md5 (fingerprint.py:475-479)
        for group in groups:
            hashes = [item["file_hash"] for item in group]
            for item in group:
                item["exact_duplicate"] = hashes.count(item["file_hash"]) > 1
        return groups

    def _similarities_full(self, embeddings: np.ndarray) -> np.ndarray:
        e = torch.from_numpy(embeddings).to(self.device)
        with full_fp32():
            return (e @ e.T).cpu().numpy()

    def _find_duplicates_direct(self, embeddings, paths, fingerprints, threshold):
        """All-pairs matrix + greedy grouping (fingerprint.py:482-513)."""
        sims = self._similarities_full(embeddings)
        processed = set()
        groups = []
        for i in range(len(embeddings)):
            if i in processed:
                continue
            similar = np.where(sims[i] >= threshold)[0]
            if len(similar) > 1:
                group = []
                for idx in similar:
                    if idx not in processed:
                        processed.add(int(idx))
                        item = dict(fingerprints[paths[idx]])
                        item["similarity"] = float(sims[i, idx])
                        group.append(item)
                if len(group) > 1:
                    groups.append(group)
        return groups

    def _find_duplicates_topk(self, embeddings, paths, fingerprints, threshold):
        """k-NN candidates from exact top-k + the greedy grouping the
        reference applies to its FAISS results (fingerprint.py:515-548)."""
        n = len(embeddings)
        sims, idx = topk_cosine(torch.from_numpy(embeddings).to(self.device), min(20, n))
        sims, idx = sims.cpu().numpy(), idx.cpu().numpy()

        processed = set()
        groups = []
        for i in range(n):
            if i in processed:
                continue
            group = []
            for sim, j in zip(sims[i], idx[i]):
                if sim >= threshold and int(j) not in processed:
                    processed.add(int(j))
                    item = dict(fingerprints[paths[int(j)]])
                    item["similarity"] = float(sim)
                    group.append(item)
            if len(group) > 1:
                groups.append(group)
        return groups


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
