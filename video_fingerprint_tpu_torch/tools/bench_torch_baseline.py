"""Reference baseline: the upstream PyTorch model on the CPU at batch 1.

Port of tools/bench_torch_baseline.py. Batch 1 is the reference scanner's
own regime (it cannot batch videos of different lengths). The reference is
executed from the checkout that --reference_dir names (its `model.py`),
not copied; it is never looked for elsewhere. Without the flag, or without
a `model.py` there, the leg prints `reference_torch_cpu_vps: -1` and the
orchestrator's `vs_baseline` is -1. It times 20 videos of 128 64x64 frames
and prints the median rate and the interquartile range of per-video rates.

    python -m video_fingerprint_tpu_torch.tools.bench_torch_baseline \\
        [--reference_dir DIR]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from video_fingerprint_tpu_torch.tools.bench_common import emit

T = 128
HW = 64
N_VIDEOS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference_dir", type=Path, default=None,
                    help="the reference checkout (its model.py is run)")
    args = ap.parse_args(argv)
    if args.reference_dir is None or not (args.reference_dir / "model.py").exists():
        where = args.reference_dir or "no --reference_dir given"
        emit({"reference_torch_cpu_vps": -1.0,
              "reference_note": f"no reference model.py ({where})"})
        return 0
    sys.path.insert(0, str(args.reference_dir))
    import model as ref  # executed, not copied

    torch.manual_seed(0)
    m = ref.create_model("attention")
    m.eval()
    rng = np.random.default_rng(0)
    clips = [torch.from_numpy(rng.random((1, T, 3, HW, HW), dtype=np.float32))
             for _ in range(4)]
    with torch.no_grad():
        m(clips[0])  # warm-up
        times = []
        for i in range(N_VIDEOS):
            t0 = time.perf_counter()
            m(clips[i % len(clips)])
            times.append(time.perf_counter() - t0)
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    emit({"reference_torch_cpu_vps": 1.0 / float(med),
          # per-video rate spread: 1/q3 (slow quartile) .. 1/q1 (fast quartile)
          "reference_torch_cpu_iqr_vps": [1.0 / float(q3), 1.0 / float(q1)],
          "reference_videos_timed": N_VIDEOS})
    return 0


if __name__ == "__main__":
    sys.exit(main())
