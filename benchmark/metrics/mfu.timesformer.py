"""mfu.timesformer: TimeSformer's operations on the windows the window
completed (harness/flops_timesformer.py: 391.66 GFLOP a window at
TimeSformer-Base's widths), over the window, against the bf16 peak, in
percent."""

from benchmark.harness import flops
from benchmark.harness.flops_timesformer import window_flops


def read(r):
    if r.cell.config.get("model_type") != "timesformer":
        return None
    windows = sum(len(video) for video in r.work["video_frames"])
    if not windows:
        return None
    return 100.0 * windows * window_flops(r.cell.config) / r.trace.window_s / flops.BF16_PEAK_FLOPS
