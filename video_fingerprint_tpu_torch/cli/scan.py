"""Scanner CLI: `python -m video_fingerprint_tpu_torch.cli.scan`.

The flag surface of video_fingerprint_tpu/cli/scan.py for a scan on one
card: either model family (from the checkpoint's config), the persistent
`--index` (incremental re-scans), and `--against` (query-vs-corpus search).
`--device` is cuda (default) or cpu; cuda without a card is an error, not a
fallback. Not ported: `--native_decode`, `--native_preprocess` and
`--data_parallel`.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Video fingerprint scanner and duplicate detector (PyTorch/CUDA)",
    )
    parser.add_argument("--model", type=str, required=True,
                        help="Path to a trained checkpoint (.ckpt or reference .pth)")
    parser.add_argument("--scan", type=str, required=True,
                        help="Folder containing videos to scan")
    parser.add_argument("--threshold", type=float, default=0.99,
                        help="Similarity threshold for duplicates (0-1, default: 0.99)")
    parser.add_argument("--output", type=str, help="JSON file to save the results")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                        help="Device to use (default: cuda)")
    parser.add_argument("--extensions", type=str, nargs="+",
                        default=[".mp4", ".avi", ".mov", ".mkv"],
                        help="Video file extensions to scan")
    parser.add_argument("--workers", type=int, default=4,
                        help="Number of decode workers")
    parser.add_argument("--batch", type=int, default=8,
                        help="Device batch size for bucketed extraction")
    parser.add_argument("--no_batched", action="store_true",
                        help="Disable bucketed batching (sequential batch=1)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute")
    parser.add_argument("--no_optimize", action="store_true",
                        help="Disable the fused inference layout (BN folded "
                             "into conv weights; lossless, on by default)")
    parser.add_argument("--warmup", action="store_true",
                        help="Run each bucket's forward once before scanning")
    parser.add_argument("--index", type=str,
                        help="Persistent scan index (.npz): reuse fingerprints "
                             "for unchanged files (size + content hash) and "
                             "save the updated index after the scan. Entries "
                             "for files outside the scanned folder are kept, "
                             "so one index can serve several libraries")
    parser.add_argument("--against", type=str,
                        help="Query-vs-corpus mode: search the scanned videos "
                             "against this persisted corpus index (.npz, from "
                             "a previous --index scan) and report "
                             "cross-duplicates instead of duplicates within "
                             "the scanned folder")
    parser.add_argument("--index_storage", choices=("f32", "bf16"), default="f32",
                        help="Embedding storage for the saved --index: bf16 "
                             "halves the file and the corpus on the card; "
                             "searches score true cosines of the stored "
                             "vectors")
    parser.add_argument("--no_prune", action="store_true",
                        help="Keep index entries for files that are missing "
                             "on disk (shared or networked indexes where a "
                             "mount may be absent for a while)")
    return parser


def _kept_entries(cache, fingerprints, scan_root: Path, no_prune: bool):
    """The prior index entries to save again: all of them with no_prune;
    otherwise every entry but those whose absolute path lies under the scan
    root and whose file is gone. A scan attests deletions only inside its
    own root, so another library's entries, and relative paths from a scan
    run elsewhere, are kept."""
    def under_root(p: str) -> bool:
        try:
            return Path(p).resolve().is_relative_to(scan_root)
        except (OSError, ValueError):
            return False

    return {p: fp for p, fp in cache.items()
            if p in fingerprints or no_prune or not Path(p).is_absolute()
            or not under_root(p) or Path(p).exists()}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from video_fingerprint_tpu_torch.inference.report import (
        print_duplicate_report,
        save_results,
    )
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    print("Starting video fingerprint scanner")
    print("=" * 80)

    if not Path(args.model).exists():
        print(f"Error: Model checkpoint {args.model} does not exist")
        return 1

    scanner = FingerprintScanner(
        args.model, device=args.device, batch_size=args.batch, bf16=args.bf16,
        optimize=not args.no_optimize,
    )

    video_dir = Path(args.scan)
    if not video_dir.exists():
        print(f"Error: Folder {video_dir} does not exist")
        return 1

    if args.warmup:
        print("Warming up batched extraction...")
        scanner.warmup()

    corpus_index = None
    if args.against:
        from video_fingerprint_tpu_torch.inference.index import FingerprintIndex

        if not Path(args.against).exists():
            print(f"Error: Corpus index {args.against} does not exist")
            return 1
        corpus_index = FingerprintIndex.load(args.against, device=args.device)
        print(f"Loaded corpus index with {len(corpus_index)} fingerprints "
              f"from {args.against}")

    cache = None
    if args.index:
        from video_fingerprint_tpu_torch.inference.scan_cache import load_cache

        cache = load_cache(args.index, expect_identity=scanner.model_identity)
        if cache:
            print(f"Loaded scan index with {len(cache)} fingerprints from {args.index}")

    fingerprints = scanner.scan_directory(
        video_dir,
        extensions=args.extensions,
        num_workers=args.workers,
        batched=not args.no_batched,
        cache=cache,
    )
    if not fingerprints:
        print("No videos could be analyzed")
        return 1

    if args.index:
        from video_fingerprint_tpu_torch.inference.scan_cache import save_cache

        # merge the prior cache (rescans win); prune deleted files in the root
        kept = _kept_entries(cache or {}, fingerprints, video_dir.resolve(), args.no_prune)
        pruned = len(cache or {}) - len(kept)
        if pruned:
            print(f"Pruned {pruned} index entries for deleted files")
        save_cache(args.index, {**kept, **fingerprints},
                   model_identity=scanner.model_identity, storage=args.index_storage)
        print(f"Scan index saved to {args.index}")

    if corpus_index is not None:
        try:
            duplicate_groups = scanner.find_duplicates_against(
                fingerprints, corpus_index, similarity_threshold=args.threshold)
        except ValueError as e:
            print(f"Error: {e}")
            return 1
    else:
        duplicate_groups = scanner.find_duplicates(
            fingerprints, similarity_threshold=args.threshold)
    print_duplicate_report(duplicate_groups)

    if args.output:
        save_results(
            fingerprints, duplicate_groups, Path(args.output),
            scanner.config, scanner.model_type,
        )

    print("\nScan complete!")
    return 0


if __name__ == "__main__":
    sys.exit(main())
