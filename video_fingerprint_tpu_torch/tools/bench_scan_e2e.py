"""End-to-end scan benchmark with decode.

Port of tools/bench_scan_e2e.py. It drives the whole scan: decode in host
workers, preprocess, bucketed masked batching, the forward on the card and
the duplicate grouping, over a synthetic mp4 corpus of which a fifth are
byte-identical copies, and reports videos/s with decode. The timed window
is the scan loop only, as the reference prints its rate after the scan and
before the duplicate search. The default corpus (60 small clips) makes a
window of about two seconds, so the leg first scans it once untimed (the
decode pool's start, each bucket's first forward, the files into the page
cache), then reports the median of TIMED_SCANS timed scans beside each
run's rate, and the rate of the decode stage alone (`decode_clips` with
the same workers, the clips dropped), which says whether the scan is
decode-bound.

A copy scores 1.0 whatever the weights, so `e2e_planted_pairs_found`
checks the grouping, not the model; that distinct videos stay apart at the
threshold shows as `e2e_duplicate_groups` equal to `e2e_planted_pairs`.

The corpus and a seeded checkpoint (tools/bench_common.py, written with the
port's save_checkpoint in the JAX package's format) are cached under
--cache-dir, so repeated runs skip writing videos. --native-decode that
cannot be honoured (utils/native_decode.py did not build) fails instead of
decoding with cv2.

    python -m video_fingerprint_tpu_torch.tools.bench_scan_e2e [--videos 60]
        [--frames 96] [--device cuda|cpu] [--workers 8] [--native-decode]
        [--threshold 0.95] [--f32] [--cache-dir DIR]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path
from typing import List, Tuple

from video_fingerprint_tpu_torch.tools.bench_common import emit, seeded_state_dict

DEFAULT_CACHE = Path(__file__).resolve().parents[2] / ".bench_cache" / "torch_e2e"
CHECKPOINT_SEED = 42
TIMED_SCANS = 3


def ensure_corpus(cache_dir: Path, num_videos: int, num_frames: int) -> Path:
    """The synthetic mp4 corpus, a fifth of it exact duplicates."""
    from video_fingerprint_tpu_torch.utils.synthetic import make_corpus

    d = Path(cache_dir) / f"corpus_v{num_videos}_f{num_frames}"
    marker = d / ".complete"
    if marker.exists():
        return d
    dups = max(1, num_videos // 5)
    make_corpus(d, num_unique=num_videos - dups, num_frames=num_frames, duplicates=dups)
    marker.write_text("ok")
    return d


def ensure_checkpoint(cache_dir: Path) -> Path:
    """The seeded full-width attention model as a `.ckpt` (the JAX
    package's format)."""
    from video_fingerprint_tpu_torch.training.checkpoint import save_checkpoint
    from video_fingerprint_tpu_torch.utils.torch_compat import state_dict_to_variables

    path = Path(cache_dir) / "bench_model.ckpt"
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    variables = state_dict_to_variables(seeded_state_dict(CHECKPOINT_SEED), "attention")
    config = {"model_type": "attention", "frame_size": 64, "max_frames": 500,
              "embedding_dim": 256, "spatial_dim": 128, "temporal_dim": 256,
              "num_attention_blocks": 4}
    save_checkpoint(path, variables["params"], variables["batch_stats"], config)
    return path


def planted_pairs_found(groups: List[List[str]], names: List[str]) -> Tuple[int, int]:
    """(planted copies, copies grouped with their original): make_corpus
    names a copy of video_i.mp4 video_i_copy.mp4."""
    copies = [n for n in names if n.endswith("_copy.mp4")]
    together = {frozenset((a, b)) for g in groups for a in g for b in g if a != b}
    found = sum(frozenset((c.replace("_copy", ""), c)) in together for c in copies)
    return len(copies), found


def run(num_videos: int = 60, num_frames: int = 96, device: str = "cuda",
        workers: int = 8, batch: int = 16, native_decode: bool = False,
        threshold: float = 0.95, cache_dir: Path = DEFAULT_CACHE,
        bf16: bool = True) -> Tuple[dict, List[List[str]]]:
    """Scan the cached corpus; returns (the result, the duplicate groups as
    sorted lists of file names)."""
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner
    from video_fingerprint_tpu_torch.utils import native_decode as native_decode_lib

    if native_decode and not native_decode_lib.available():
        raise RuntimeError("native decode requested but unavailable: "
                           + native_decode_lib.LIBRARY.error)
    corpus = ensure_corpus(cache_dir, num_videos, num_frames)
    ckpt = ensure_checkpoint(cache_dir)
    scanner = FingerprintScanner(str(ckpt), device=device, batch_size=batch,
                                 native_decode=native_decode, bf16=bf16)
    t0 = time.perf_counter()
    scanner.warmup(num_frames)  # the bucket's forward and the kernel build
    scanner.scan_directory(corpus, num_workers=workers, batched=True)
    warmup_s = time.perf_counter() - t0

    paths = sorted(corpus.rglob("*.mp4"))
    t0 = time.perf_counter()
    decoded = sum(clip is not None for _, clip in scanner.decode_clips(paths, workers))
    decode_s = time.perf_counter() - t0

    runs = []
    for _ in range(TIMED_SCANS):
        t0 = time.perf_counter()
        fingerprints = scanner.scan_directory(corpus, num_workers=workers, batched=True)
        runs.append(time.perf_counter() - t0)
    elapsed = statistics.median(runs)
    groups = scanner.find_duplicates(fingerprints, similarity_threshold=threshold)
    groups = sorted(sorted(Path(item["path"]).name for item in g) for g in groups)
    planted, found = planted_pairs_found(groups, [Path(p).name for p in fingerprints])

    n = len(fingerprints)
    return {
        "e2e_scan_vps_with_decode": n / elapsed,
        "e2e_videos": n,
        "e2e_frames_per_video": num_frames,
        "e2e_elapsed_s": elapsed,
        "e2e_scan_vps_runs": [n / t for t in runs],
        "e2e_decode_only_vps": decoded / decode_s,
        "e2e_warmup_s": warmup_s,
        "e2e_decode_workers": workers,
        "e2e_native_decode": bool(scanner.native_decode),
        "e2e_dtype": "bfloat16" if bf16 else "float32",
        "e2e_threshold": threshold,
        "e2e_duplicate_groups": len(groups),
        "e2e_group_sizes": sorted(len(g) for g in groups),
        "e2e_planted_pairs": planted,
        "e2e_planted_pairs_found": found,
        "e2e_device": str(scanner.device),
    }, groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--videos", type=int, default=60)
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--native-decode", action="store_true")
    ap.add_argument("--threshold", type=float, default=0.95)
    ap.add_argument("--cache-dir", type=Path, default=DEFAULT_CACHE)
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute (default bf16, the production setting)")
    args = ap.parse_args(argv)
    result, _ = run(num_videos=args.videos, num_frames=args.frames, device=args.device,
                    workers=args.workers, batch=args.batch,
                    native_decode=args.native_decode, threshold=args.threshold,
                    cache_dir=args.cache_dir, bf16=not args.f32)
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
