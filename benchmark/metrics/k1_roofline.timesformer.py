"""k1_roofline.timesformer: the attention kernel K1's least time over its
device time (kernels named attention_bf16 / attention_f32), in percent, for
both of TimeSformer's attentions. Per completed window and layer: N H
instances of T = num_frames (temporal) and T H of 1 + N tokens (spatial);
for each kind the larger of 4 T^2 D operations an instance at the bf16 peak
and q, k, v and o at HBM bandwidth (harness/flops_timesformer.py)."""

from benchmark.harness import flops
from benchmark.harness.flops_timesformer import k1_least_seconds
from benchmark.harness.trace import busy_seconds

KERNELS = ("attention_bf16", "attention_f32")


def read(r):
    kernels = r.trace.kernels(name_has=KERNELS)
    if not kernels or r.cell.config.get("model_type") != "timesformer":
        return None
    windows = sum(len(video) for video in r.work["video_frames"])
    least = windows * k1_least_seconds(r.cell.config, flops.BF16_PEAK_FLOPS,
                                       flops.HBM_BYTES_PER_S)
    return 100.0 * least / busy_seconds(kernels)
