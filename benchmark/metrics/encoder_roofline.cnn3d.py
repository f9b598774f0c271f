"""encoder_roofline.cnn3d: the 3D encoder's least time over its device time,
in percent. Its kernels are those launched inside the encoder's forward
("bench.encoder"). The least time is the larger of its convs' operations
on the completed windows (their own lengths, padded by the model to its
stride) at the bf16 peak and its bytes (uint8 frames in, weights once a
call, features out) at HBM bandwidth."""

from benchmark.harness import flops
from benchmark.harness.trace import busy_seconds

RANGE = "bench.encoder"


def read(r):
    kernels = r.trace.kernels(within=RANGE)
    if not kernels:
        return None
    config = r.cell.config
    windows = [t for video in r.work["video_frames"] for t in video]
    work = sum(flops.cnn3d_encoder_flops(config, t) for t in windows)
    nbytes = (sum(t * flops.frame_bytes(config) + flops.cnn3d_encoder_out_bytes(config, t)
                  for t in windows)
              + r.trace.count(RANGE) * flops.cnn3d_encoder_weight_bytes(config))
    return 100.0 * flops.roofline_seconds(work, nbytes) / busy_seconds(kernels)
