"""encoder_roofline.attn: the frame CNN's least time over its device time,
in percent. Its kernels are those launched inside the spatial encoder's
forward ("bench.spatial_encoder"). The least time is the larger of its
operations on the completed videos' own frames at the bf16 peak and its
bytes (uint8 frames in, weights once a call, features out) at HBM
bandwidth."""

from benchmark.harness import flops
from benchmark.harness.trace import busy_seconds

RANGE = "bench.spatial_encoder"


def read(r):
    kernels = r.trace.kernels(within=RANGE)
    if not kernels:
        return None
    config = r.cell.config
    frames = sum(r.work["video_frames"])
    work = frames * flops.frame_flops(config)
    nbytes = (frames * (flops.frame_bytes(config)
                        + config["spatial_dim"] * flops.element_bytes(config))
              + r.trace.count(RANGE) * flops.spatial_encoder_weight_bytes(config))
    return 100.0 * flops.roofline_seconds(work, nbytes) / busy_seconds(kernels)
