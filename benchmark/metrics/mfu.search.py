"""mfu.search: the search's operations (2 Q N D a call) over the window,
against the bf16 peak, in percent."""

from benchmark.harness import flops


def read(r):
    w = r.work
    if not w["calls"]:
        return None
    total = w["calls"] * 2 * w["queries_per_call"] * w["index_rows"] * w["dim"]
    return 100.0 * total / r.trace.window_s / flops.BF16_PEAK_FLOPS
