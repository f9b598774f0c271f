"""Build a synthetic corpus of hundreds of mp4s of varied lengths.

Port of tools/make_trajectory_corpus.py, through the port's
utils/synthetic.py (no framework is involved): procedurally generated
videos of `--min-frames` to `--max-frames` frames, which exercise the
bucketed loader, the augmentation pipeline and the pair samplers at a
closer-to-real scale. The same flags, file names and `.complete` stamp as
the JAX tool, so a corpus built by either is accepted by the other; a
directory whose stamp names other parameters is refused.

    python -m video_fingerprint_tpu_torch.tools.make_trajectory_corpus
        [--out DIR] [--videos 150] [--min-frames 48] [--max-frames 160] [--hard]

The default --out lies under the temporary directory.
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np

from video_fingerprint_tpu_torch.utils.synthetic import (
    synthetic_frames,
    synthetic_frames_near,
    write_video,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(Path(tempfile.gettempdir()) / "vfp_traj" / "videos"))
    ap.add_argument("--videos", type=int, default=150)
    ap.add_argument("--min-frames", type=int, default=48)
    ap.add_argument("--max-frames", type=int, default=160)
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("--hard", action="store_true",
                    help="Near-duplicate distractor families (4 videos per base pattern "
                         "sharing 75%% of their content): keeps validation AUC off the 1.0 "
                         "ceiling so model selection and early stopping discriminate")
    ap.add_argument("--per-family", type=int, default=4)
    ap.add_argument("--mix", type=float, default=0.25)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = Path(args.out)
    marker = out / ".complete"
    stamp = (f"{args.videos}:{args.min_frames}:{args.max_frames}:{args.seed}"
             + (f":hard{args.per_family}x{args.mix}" if args.hard else ""))
    if marker.exists():
        if marker.read_text() == stamp:
            print(f"corpus already complete at {out}")
            return 0
        raise SystemExit(f"{out} holds a corpus built with different parameters "
                         f"({marker.read_text()} != {stamp}) — pick a fresh --out")
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.videos):
        t = int(rng.integers(args.min_frames, args.max_frames + 1))
        if args.hard:
            base_seed = args.seed + 100000 + i // args.per_family
            frames = synthetic_frames_near(args.seed + i, base_seed, t, mix=args.mix)
            name = f"fam{i // args.per_family:03d}_v{i % args.per_family}.mp4"
        else:
            frames = synthetic_frames(args.seed + i, t)
            name = f"traj_{i:04d}.mp4"
        write_video(out / name, frames)
        if (i + 1) % 25 == 0:
            print(f"{i + 1}/{args.videos}", flush=True)
    marker.write_text(stamp)
    print(f"corpus complete: {args.videos} videos at {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
