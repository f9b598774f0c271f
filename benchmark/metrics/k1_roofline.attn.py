"""k1_roofline.attn: the temporal attention kernel K1's least time over its
device time (kernels named attention_bf16 / attention_f32), in percent.
Per completed video of T frames and per attention block: 4 T^2 C
operations (QK^T and PV over every head) at the bf16 peak, or q, k, v and
the output (T x C each, in the compute dtype) and the key mask (T bytes)
at HBM bandwidth, whichever takes longer."""

from benchmark.harness import flops
from benchmark.harness.trace import busy_seconds

KERNELS = ("attention_bf16", "attention_f32")


def read(r):
    kernels = r.trace.kernels(name_has=KERNELS)
    if not kernels:
        return None
    config = r.cell.config
    C, blocks = config["temporal_dim"], config["num_attention_blocks"]
    size = flops.element_bytes(config)
    least = sum(blocks * flops.roofline_seconds(4 * t * t * C, 4 * t * C * size + t)
                for t in r.work["video_frames"])
    return 100.0 * least / busy_seconds(kernels)
