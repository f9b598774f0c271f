"""Per-core decode rate: the cv2 path against the native libav worker.

Port of tools/bench_decode_percore.py. The e2e scan is decode-bound, and
its projection to more host cores rests on one number: frames/s for ONE
worker doing the scanner's whole host job, subsampled decode + short-side
scale + centre crop to (n, size, size, 3) uint8. This measures it for the
cv2 path (data/decode.py::decode_subsampled + data/preprocess.py::
resize_short_side_center_crop) and for the fused native path
(native/vfp_decode.cc through utils/native_decode.py::decode_scan) where
that library builds. Where it does not, the line carries `native_error`
(the library's build error) and no native rate or ratio.

Each path decodes the synthetic corpus once to warm the page cache (and
build the library), then `--reps` passes over every video; the rate is the
best pass's frames/s, as in the JAX tool. The videos are written once into
--out (a temporary folder when not given) from seeded synthetic frames of
96 x 128, the e2e leg's size.

    python -m video_fingerprint_tpu_torch.tools.bench_decode_percore [--videos 8]
        [--frames 240] [--max-frames 64] [--size 64] [--reps 3] [--out DIR]

Prints one JSON line with the JAX tool's keys: metric, unit, videos,
source_frames, decoded_frames_per_video, size, cv2_fps, native_fps,
native_over_cv2 (the last two null without the native library), and
frames_per_pass, the frames one pass decoded.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

from video_fingerprint_tpu_torch.data import decode, preprocess
from video_fingerprint_tpu_torch.utils import native_decode
from video_fingerprint_tpu_torch.utils.synthetic import synthetic_frames, write_video


def cv2_job(path, max_frames: int, size: int) -> int:
    frames = decode.decode_subsampled(path, max_frames)
    return len([preprocess.resize_short_side_center_crop(f, size) for f in frames])


def native_job(path, max_frames: int, size: int) -> int:
    out = native_decode.decode_scan(path, max_frames, size)
    return 0 if out is None else out.shape[0]


def time_path(job, paths, max_frames: int, size: int, reps: int):
    """(best frames/s over `reps` passes, frames per pass), after a warm pass."""
    for p in paths:
        job(p, max_frames, size)
    best, n = 0.0, 0
    for _ in range(reps):
        t0 = time.perf_counter()
        n = sum(job(p, max_frames, size) for p in paths)
        best = max(best, n / (time.perf_counter() - t0))
    return best, n


def corpus(out: Path, videos: int, frames: int):
    """`videos` seeded synthetic mp4s of `frames` 96x128 frames in `out`."""
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(videos):
        p = out / f"bench_{i}_{frames}.mp4"
        if not p.exists():
            write_video(p, synthetic_frames(i, frames))
        paths.append(str(p))
    return paths


def run(args) -> dict:
    with tempfile.TemporaryDirectory(prefix="vfp_decode_bench_") as tmp:
        paths = corpus(Path(args.out or tmp), args.videos, args.frames)
        cv2_fps, n_cv2 = time_path(cv2_job, paths, args.max_frames, args.size, args.reps)
        result = {"metric": "single-worker decode+scale+crop throughput",
                  "unit": "frames/sec/core", "videos": args.videos,
                  "source_frames": args.frames, "decoded_frames_per_video": args.max_frames,
                  "size": args.size, "cv2_fps": cv2_fps, "native_fps": None,
                  "native_over_cv2": None,
                  "frames_per_pass": n_cv2}
        if native_decode.available():
            nat_fps, n_nat = time_path(native_job, paths, args.max_frames, args.size, args.reps)
            if n_nat != n_cv2:
                raise AssertionError(f"native decoded {n_nat} frames, cv2 {n_cv2}")
            result.update(native_fps=nat_fps, native_over_cv2=nat_fps / cv2_fps)
        else:
            result["native_error"] = native_decode.LIBRARY.error[-600:]
    print(json.dumps(result), flush=True)
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--videos", type=int, default=8)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--max-frames", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="folder for the synthetic videos "
                                                "(default: a temporary one)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
