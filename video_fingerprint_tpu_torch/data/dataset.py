"""Dataset, sample index and bucketed loader: a copy of
video_fingerprint_tpu/data/dataset.py (the same seeded sampling, so the same
seed and epoch give the JAX pipeline's arrays), with the native decode path
left out until the port has its native host paths (ROADMAP item 14):
decode_backend="native" prints the JAX package's unavailable-decoder message
and decodes with cv2.

Reference parity targets: `VideoFingerprintDataset` (dataset.py:12-492),
`collate_fn_padding` (dataset.py:495-528), `create_dataloader`
(dataset.py:531-579). TPU-first differences:

  - deterministic, shardable sampling: every sample's RNG derives from
    (seed, epoch, index), and the index is sharded per host
    (`jax.process_index()`-style shard_index/shard_count) — the reference
    uses unseeded global RNGs and has no multi-host story;
  - batches are zero-padded to a *length bucket* (not batch-max) and carry a
    boolean frame mask, so XLA compiles one program per bucket and the model
    can exclude padding (the reference pads to batch max and lets padded
    frames attend, dataset.py:507-524);
  - decode workers are threads (cv2/PyAV release the GIL) with bounded
    prefetch, feeding the device while it computes.
"""

from __future__ import annotations

import collections
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from video_fingerprint_tpu_torch.data import augment as aug
from video_fingerprint_tpu_torch.data import decode, pairs, preprocess

VIDEO_EXTENSIONS = ("*.mp4", "*.avi", "*.mov", "*.mkv")


class VideoFingerprintDataset:
    """Indexes a directory of videos and produces contrastive clip pairs."""

    def __init__(
        self,
        video_dir,
        frame_size: int = 64,
        max_frames: int = 1000,
        clip_length: int = 128,
        frame_stride: int = 32,
        min_extract_ratio: float = 0.5,
        augment: bool = True,
        cache_videos: bool = True,
        mode: str = "train",
        model_type: str = "attention",
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        decode_backend: str = "cv2",
        augment_mode: str = "host",
    ):
        self.video_dir = Path(video_dir)
        # "host": full reference augmentation pipeline in the loader.
        # "device": the loader applies only resize + JPEG recompression; the
        # remaining transforms run inside the jitted train step
        # (ops/device_augment.py) — the train CLI's --device_augment.
        self.augment_mode = augment_mode
        self.frame_size = frame_size
        self.max_frames = max_frames
        self.clip_length = clip_length
        self.frame_stride = frame_stride
        self.min_extract_ratio = min_extract_ratio
        self.augment = augment
        self.mode = mode
        self.model_type = model_type
        self.seed = seed
        self.cache_videos = cache_videos
        self._cache: Dict[str, List[np.ndarray]] = {}

        # Native fused decode applies to eval-mode attention loads only in
        # the JAX package; the port has no native decoder yet, so it says
        # so as JAX does when its decoder is unavailable, and uses cv2.
        if decode_backend == "native" and not augment and model_type == "attention":
            print("native decode requested but unavailable; using cv2")

        self.video_paths: List[Path] = []
        for ext in VIDEO_EXTENSIONS:
            self.video_paths.extend(self.video_dir.glob(f"**/{ext}"))
        self.video_paths = sorted(self.video_paths)

        if model_type == "attention":
            self.samples = [
                {"path": p, "video_id": i} for i, p in enumerate(self.video_paths)
            ]
        else:
            self.samples = self._build_3d_clip_index()

        # deterministic per-host shard. Shards are
        # truncated to equal size (dropping <= shard_count-1 samples): every
        # host must run the SAME number of batches per epoch or the jitted
        # step's collectives deadlock mid-epoch.
        self.shard_index = shard_index
        self.shard_count = shard_count
        total = len(self.samples)
        self.samples = self.samples[shard_index::shard_count]
        if shard_count > 1:
            self.samples = self.samples[: total // shard_count]

        # Multi-host bucket agreement: every host derives an
        # upper bound on each GLOBAL sample's clip length from container
        # metadata alone (min(probed total_frames, max_frames) — decode
        # subsampling and extract sampling only shorten clips), so the
        # per-step bucket can be computed identically everywhere without
        # seeing other hosts' pixels. BucketedLoader turns this into a
        # shared (seed, epoch, step)-deterministic bucket schedule.
        self.global_est_lengths: Optional[np.ndarray] = None
        if shard_count > 1 and model_type == "attention":
            from concurrent.futures import ThreadPoolExecutor

            def probe_cap(path):
                try:
                    info = decode.probe(path)
                    if info and info.total_frames > 0:
                        return min(info.total_frames, self.max_frames)
                except Exception:
                    pass
                return self.max_frames  # unknown: safe upper bound

            with ThreadPoolExecutor(max_workers=8) as pool:
                self.global_est_lengths = np.asarray(
                    list(pool.map(probe_cap, self.video_paths)), np.int64
                )

        print(f"Found {len(self.video_paths)} videos")
        print(f"Dataset mode: {model_type}, Total samples: {len(self)}")

    def _build_3d_clip_index(self) -> List[dict]:
        """<=5 clips per long video for training (dataset.py:57-104).
        Probes run in a thread pool (cv2 releases the GIL) — the reference's
        serial per-video probe loop is an IO hot spot at corpus scale."""
        from concurrent.futures import ThreadPoolExecutor

        def probe_safe(path):
            try:
                return decode.probe(path)
            except Exception:
                return None

        with ThreadPoolExecutor(max_workers=8) as pool:
            infos = list(pool.map(probe_safe, self.video_paths))

        # per-video probe failures degrade gracefully (the video is excluded,
        # like the reference's per-video try/except), but a systemic decode
        # fault must fail loudly, not yield a silently tiny training set.
        n_failed = sum(1 for i in infos if i is None)
        if n_failed:
            print(f"WARNING: {n_failed}/{len(infos)} videos failed the "
                  f"frame-count probe and are excluded from the 3D clip index")
        if infos and n_failed == len(infos):
            raise RuntimeError(
                "every video failed decode.probe — decode backend broken?"
            )

        samples = []
        for video_id, (path, info) in enumerate(zip(self.video_paths, infos)):
            if info is None:
                continue
            total = info.total_frames
            if total >= self.clip_length and self.mode == "train":
                # the 32-frame hop between candidate clips is hardcoded by
                # the reference too (dataset.py:74) — it is NOT frame_stride
                num_clips = min(5, (total - self.clip_length) // 32 + 1)
                for i in range(num_clips):
                    samples.append(
                        {"path": path, "video_id": video_id,
                         "total_frames": total, "clip_idx": i}
                    )
            else:
                samples.append(
                    {"path": path, "video_id": video_id,
                     "total_frames": total, "clip_idx": 0}
                )
        return samples

    def __len__(self) -> int:
        return len(self.samples)

    def _rng(self, epoch: int, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, idx])
        )

    def _load_full(self, path: Path, rng: np.random.Generator) -> List[np.ndarray]:
        """Full-video subsampled decode with train-time speed jitter
        (dataset.py:109-158), cached like the reference (first decode wins)."""
        key = str(path)
        # draw the speed jitter BEFORE the cache check: consuming the RNG
        # only on cache misses would make every later draw (pair sampling,
        # augmentations) depend on which paths happen to be cached — i.e. on
        # thread scheduling — breaking the (seed, epoch, idx) determinism
        # contract. The draw is wasted on a cache hit; determinism is not.
        speed = (
            rng.uniform(0.5, 2.0)
            if (self.augment and self.mode == "train") else None
        )
        if self.cache_videos and key in self._cache:
            return self._cache[key]

        skip_rate = None
        if speed is not None:
            info = decode.probe(path)
            if info and info.total_frames > 0:
                skip_rate = max(1, int((info.total_frames // self.max_frames) * speed))

        frames = decode.decode_subsampled(path, self.max_frames, skip_rate=skip_rate)
        if not frames:
            frames = decode.black_fallback_frames(30)
        if self.cache_videos and len(self._cache) < 100:
            self._cache[key] = frames
        return frames

    def get(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        rng = self._rng(epoch, idx)
        if self.model_type == "attention":
            return self._get_attention(idx, rng)
        return self._get_3d(idx, rng)

    def _finalize_pair(self, frames1, frames2, rng, video_id):
        frames1 = [
            aug.train_resize_frame(f, self.frame_size, rng, True, self.augment)
            for f in frames1
        ]
        frames2 = [
            aug.train_resize_frame(f, self.frame_size, rng, True, self.augment)
            for f in frames2
        ]
        if self.augment:
            if self.augment_mode == "device":
                frames1 = aug.apply_jpeg_only(frames1, rng)
                frames2 = aug.apply_jpeg_only(frames2, rng)
            else:
                frames1 = aug.apply_augmentations(frames1, rng, self.frame_size)
                frames2 = aug.apply_augmentations(frames2, rng, self.frame_size)
        # uint8 clips: normalization is fused on-device (train_step.py
        # normalize_clip), quartering H2D bytes per batch.
        clip1 = preprocess.frames_to_clip_u8(frames1)
        clip2 = preprocess.frames_to_clip_u8(frames2)
        return {
            "clip1": clip1,
            "clip2": clip2,
            "video_id": np.int32(video_id),
        }

    def _get_attention(self, idx, rng):
        info = self.samples[idx]
        frames = self._load_full(info["path"], rng)
        s1, s2 = pairs.sample_extract_pair(
            len(frames), rng, self.min_extract_ratio, train=(self.mode == "train")
        )
        return self._finalize_pair(frames[s1], frames[s2], rng, info["video_id"])

    def _get_3d(self, idx, rng):
        info = self.samples[idx]
        start1, start2 = pairs.sample_clip_pair_starts(
            info["total_frames"], self.clip_length, rng,
            train=(self.mode == "train"), clip_idx=info.get("clip_idx", 0),
        )
        f1 = decode.decode_clip(info["path"], start1, self.clip_length)
        f2 = (
            [f.copy() for f in f1]
            if start2 == start1
            else decode.decode_clip(info["path"], start2, self.clip_length)
        )
        return self._finalize_pair(f1, f2, rng, info["video_id"])


class BucketedLoader:
    """Threaded, prefetching loader producing fixed-bucket padded batches.

    Yields {'clip1','clip2': (B, bucket, H, W, C) f32, 'mask1','mask2':
    (B, bucket) bool, 'video_id': (B,) i32}. For the 3D model clips are fixed
    length so the bucket is exactly clip_length.
    """

    def __init__(
        self,
        dataset: VideoFingerprintDataset,
        batch_size: int = 8,
        shuffle: bool = True,
        num_workers: int = 4,
        drop_last: bool = True,
        buckets: Optional[Sequence[int]] = None,
        seed: int = 0,
        pin_epoch: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        # pin_epoch: don't advance the epoch across iterations, so the
        # (seed, epoch, idx) contract yields THE SAME samples every pass —
        # validation loaders use this (create_dataloader mode != "train") so
        # per-epoch val metrics compare identical extract pairs instead of
        # fresh random ones (the reference re-samples
        # val extracts per epoch via unseeded RNGs — this is the repo's
        # documented determinism improvement).
        self.pin_epoch = pin_epoch
        if buckets is None:
            cap = (
                dataset.max_frames
                if dataset.model_type == "attention"
                else dataset.clip_length
            )
            buckets = preprocess.default_buckets(cap)
        self.buckets = tuple(buckets)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _sample_iter(self, order) -> Iterator[dict]:
        if self.num_workers <= 0:
            for idx in order:
                yield self.dataset.get(int(idx), self.epoch)
            return
        from concurrent.futures import ThreadPoolExecutor

        prefetch = self.num_workers * 2
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending = collections.deque()
            it = iter(order)
            for idx in it:
                pending.append(ex.submit(self.dataset.get, int(idx), self.epoch))
                if len(pending) >= prefetch:
                    break
            while pending:
                yield pending.popleft().result()
                for idx in it:
                    pending.append(ex.submit(self.dataset.get, int(idx), self.epoch))
                    break

    def _bucket_schedule(self, order) -> Optional[List[int]]:
        """Per-step buckets agreed across hosts without communication
        every host holds the same global metadata
        (dataset.global_est_lengths), the same shard arithmetic
        (global index = local*shard_count + host) and the same seeded
        permutation, so each computes the identical
        max-over-all-hosts'-step-batch length bound. Buckets then track the
        data (short corpora pad to short buckets) yet can never diverge or
        truncate: the bound dominates every host's actual clip lengths."""
        ds = self.dataset
        est = getattr(ds, "global_est_lengths", None)
        if ds.shard_count <= 1 or est is None:
            return None
        B = self.batch_size
        hosts = np.arange(ds.shard_count, dtype=np.int64)
        schedule = []
        for s in range(0, len(order), B):
            js = np.asarray(order[s : s + B], np.int64)
            global_idx = (js[:, None] * ds.shard_count + hosts[None, :]).ravel()
            schedule.append(
                preprocess.bucket_for_length(int(est[global_idx].max()), self.buckets)
            )
        return schedule

    def _collate(
        self, batch: List[dict], scheduled_bucket: Optional[int] = None
    ) -> Dict[str, np.ndarray]:
        B = len(batch)
        out: Dict[str, np.ndarray] = {
            "video_id": np.asarray([s["video_id"] for s in batch], np.int32)
        }
        # One shared bucket for both sides: a (T1, T2) pair of independent
        # buckets would make the jitted train step recompile quadratically.
        max_t = max(s[side].shape[0] for s in batch for side in ("clip1", "clip2"))
        bucket = (
            scheduled_bucket
            if scheduled_bucket is not None
            else preprocess.bucket_for_length(max_t, self.buckets)
        )
        for side in ("clip1", "clip2"):
            hwc = batch[0][side].shape[1:]
            clips = np.zeros((B, bucket) + hwc, batch[0][side].dtype)
            masks = np.zeros((B, bucket), bool)
            for i, s in enumerate(batch):
                t = s[side].shape[0]
                # the schedule's bucket is a max bound over the batch's
                # estimated lengths (_bucket_schedule); a clip longer than
                # its scheduled bucket means the length estimate and the
                # loaded sample diverged — truncating here would silently
                # drop frames, so make the invariant checkable instead
                assert t <= bucket, (
                    f"clip length {t} exceeds scheduled bucket {bucket} "
                    f"(video_id {s['video_id']}): the metadata-derived "
                    f"bucket schedule under-estimated this clip"
                )
                clips[i, :t] = s[side][:t]
                masks[i, :t] = True
            out[side] = clips
            out["mask1" if side == "clip1" else "mask2"] = masks
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch, 0xB0B])
            ).permutation(n)
        else:
            order = np.arange(n)

        schedule = self._bucket_schedule(order)
        batch: List[dict] = []
        step = 0
        for sample in self._sample_iter(order):
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield self._collate(
                    batch, schedule[step] if schedule else None
                )
                batch = []
                step += 1
        if batch and not self.drop_last:
            yield self._collate(batch, schedule[step] if schedule else None)
        if not self.pin_epoch:
            self.epoch += 1


def create_dataloader(
    video_dir,
    batch_size: int = 8,
    num_workers: int = 4,
    frame_size: int = 64,
    max_frames: int = 500,
    clip_length: int = 128,
    frame_stride: int = 16,
    mode: str = "train",
    model_type: str = "attention",
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    decode_backend: str = "cv2",
    augment_mode: str = "host",
) -> BucketedLoader:
    """Factory mirroring the reference signature (dataset.py:531-579)."""
    buckets = None
    if shard_count > 1 and model_type != "attention":
        # Multi-host 3D: clips are fixed clip_length frames, so the single
        # natural bucket is the cap. (Attention multi-host uses the shared
        # metadata-derived bucket schedule — BucketedLoader._bucket_schedule —
        # so hosts agree on a per-step bucket without pinning everything to
        # max_frames.)
        buckets = (clip_length,)
    dataset = VideoFingerprintDataset(
        video_dir=video_dir,
        frame_size=frame_size,
        max_frames=max_frames,
        clip_length=clip_length,
        frame_stride=frame_stride,
        augment=(mode == "train"),
        mode=mode,
        model_type=model_type,
        seed=seed,
        shard_index=shard_index,
        shard_count=shard_count,
        decode_backend=decode_backend,
        augment_mode=augment_mode,
    )
    return BucketedLoader(
        dataset,
        batch_size=batch_size,
        shuffle=(mode == "train"),
        num_workers=num_workers,
        drop_last=(mode == "train"),
        buckets=buckets,
        seed=seed,
        pin_epoch=(mode != "train"),
    )
