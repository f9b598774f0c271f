"""Scanner CLI: `python -m video_fingerprint_tpu_torch.cli.scan`.

The flag surface of video_fingerprint_tpu/cli/scan.py for a directory scan
on one card. `--device` is cuda (default) or cpu; cuda without a card is an
error, not a fallback.
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
    return parser


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

    fingerprints = scanner.scan_directory(
        video_dir,
        extensions=args.extensions,
        num_workers=args.workers,
        batched=not args.no_batched,
    )
    if not fingerprints:
        print("No videos could be analyzed")
        return 1

    duplicate_groups = scanner.find_duplicates(
        fingerprints, similarity_threshold=args.threshold
    )
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
