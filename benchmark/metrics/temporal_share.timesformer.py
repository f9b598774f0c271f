"""temporal_share.timesformer: percent of the window's busy kernel time spent
in the blocks' temporal halves: kernels launched inside the "bench.temporal"
ranges that drivers/sampled_window_scan.py hooks around each layer's
temporal module (LayerNorm, qkv, K1 over each patch's frames, the two
projections and the residual add). Their share of the operations is
~29 %; a reading far above it is the cost of the divided layout."""

from benchmark.harness.trace import busy_seconds

RANGE = "bench.temporal"


def read(r):
    temporal = r.trace.kernels(within=RANGE)
    if not temporal:
        return None
    return 100.0 * busy_seconds(temporal) / busy_seconds(r.trace.kernels())
