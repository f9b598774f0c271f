"""mfu.scan: the model operations of the videos the window completed, each
at its own length (3D: its windows), over the window, against the bf16
peak, in percent."""

from benchmark.harness import flops


def read(r):
    config = r.cell.config
    if config["model_type"] == "attention":
        total = sum(flops.attention_video_flops(config, t) for t in r.work["video_frames"])
    else:
        total = sum(flops.cnn3d_window_flops(config, t)
                    for windows in r.work["video_frames"] for t in windows)
    if not total:
        return None
    return 100.0 * total / r.trace.window_s / flops.BF16_PEAK_FLOPS
