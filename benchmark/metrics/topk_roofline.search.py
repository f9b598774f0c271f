"""topk_roofline.search: the search's least time over the device time of the
kernels launched inside the `find_duplicates_against` calls, in percent.
Per call: 2 Q N D operations at the bf16 peak (a certified bf16 first
pass is a sound implementation, so the f32 peak would not bound it), or
the f32 corpus, the queries and the k results (f32 score, int64 row) once
at HBM bandwidth, whichever takes longer."""

from benchmark.harness import flops
from benchmark.harness.trace import busy_seconds

RANGE = "bench.find_duplicates_against"


def read(r):
    kernels = r.trace.kernels(within=RANGE)
    if not kernels:
        return None
    w = r.work
    Q, N, D, k = w["queries_per_call"], w["index_rows"], w["dim"], w["k"]
    per_call = flops.roofline_seconds(2 * Q * N * D, 4 * N * D + 4 * Q * D + 12 * Q * k)
    return 100.0 * w["calls"] * per_call / busy_seconds(kernels)
