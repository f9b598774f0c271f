"""Roofline of the thresholded dedup search: sims materialized in f32 or bf16.

Port of tools/exp_topk_bf16sims.py. The certified-bf16 search's first
stage writes a (query block, N) similarity block and reads it again for the
approximate top-k and for the certificate's counts, so at 10^5 x 256 it may
be bound by the device memory traffic on that block, not by the matmul.
Storing the block in bf16 halves every leg of that traffic; the threshold
certificate then widens by the storage rounding, 2^-9 at |sim| < 1.

Variants, each over query blocks of `--query_block` rows of a random unit
corpus (the products from bf16 inputs with f32 accumulation, the JAX
tool's DEFAULT precision; the result stored in f32 or in bf16):

  max     the product and one row-max read;
  approx  the product and the approximate top-k (ops/topk.py::_approx_topk);
  counts  the full certified first stage: approx + the threshold counts
          (ops/topk.py::_certificate, the threshold lowered by 0 in f32 and
          by 2^-9 in bf16);

and the production `topk_cosine(method="certified-bf16")` at the same
shape. Wall clock to a synchronised result, median of `--reps` after a
warm call. Beside each variant: the bytes it must move per query block
(the corpus and the block's queries read once, the sims written once and
read once per pass over them: 1 for max and approx, 2 for counts) and the
time those take at 3.35 TB/s. Each certificate is verified: on every row
it certifies, every column whose f32 similarity (the same bf16 inputs) is
>= the threshold is among the returned candidates (`certificate_holds`).

    python -m video_fingerprint_tpu_torch.tools.exp_topk_bf16sims [--n 100000]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.tools.bench_common import describe_card
from video_fingerprint_tpu_torch.tools.exp_topk_precision import bench, product
from video_fingerprint_tpu_torch.utils.device import resolve_device

PEAK_BYTES_PER_S = 3.35e12
STORE_EPS = {"f32": 0.0, "bf16": 2.0 ** -9}  # the certificate's widening per storage
OUT_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
SIMS_READS = {"max": 1, "approx": 1, "counts": 2}


def first_stage(qblk: torch.Tensor, corpus: torch.Tensor, variant: str, store: str,
                k: int, thr: float, recall: float):
    """One query block's variant on sims stored in `store`."""
    sims = product(qblk, corpus, "DEFAULT", out_dtype=OUT_DTYPE[store])
    if variant == "max":
        return (sims.max(dim=1).values.float(),)
    s, i = topk._approx_topk(sims, k, recall)
    if variant == "approx":
        return s.max(dim=1).values.float(), i[:, 0]
    ok = topk._certificate(sims, s, k, thr, True, STORE_EPS[store])
    return s.max(dim=1).values.float(), i[:, 0], ok


def certificate_holds(qblk, corpus, store: str, k: int, thr: float, recall: float):
    """(holds, certified rows) for one block: on every certified row, every
    column whose f32-stored similarity is >= thr was returned."""
    sims = product(qblk, corpus, "DEFAULT", out_dtype=OUT_DTYPE[store])
    s, i = topk._approx_topk(sims, k, recall)
    ok = topk._certificate(sims, s, k, thr, True, STORE_EPS[store])
    hit = product(qblk, corpus, "DEFAULT") >= thr
    returned = torch.zeros_like(hit).scatter_(1, i, True)
    missed = (hit & ~returned).any(dim=1) & ok
    return not bool(missed.any()), int(ok.sum())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--thr", type=float, default=0.95)
    ap.add_argument("--recall", type=float, default=0.95)
    ap.add_argument("--query_block", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    qb, k, thr = args.query_block, args.k, args.thr
    n = args.n - args.n % qb  # whole blocks only (a probe)
    if n == 0:
        raise ValueError(f"--n {args.n} holds no whole block of {qb}")
    rng = np.random.default_rng(0)
    e = rng.normal(size=(n, args.dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    e = torch.from_numpy(e).to(device)
    e16 = e.to(torch.bfloat16)  # the inputs, rounded once outside the timed calls
    n_blocks = n // qb

    results = {}
    for variant in ("max", "approx", "counts"):
        for store in ("f32", "bf16"):
            def fn():
                return [first_stage(e16[lo:lo + qb], e16, variant, store, k, thr, args.recall)
                        for lo in range(0, n, qb)]

            timed, _ = bench(fn, n, device, args.reps)
            r = {"s": timed["median_s"], "warm_s": timed["warmup_s"], "qps": timed["qps"]}
            nbytes = (n * args.dim * 2 + qb * args.dim * 2
                      + qb * n * OUT_DTYPE[store].itemsize * (1 + SIMS_READS[variant]))
            r.update(s_per_block=r["s"] / n_blocks, bytes_per_block=nbytes,
                     bound_s_per_block=nbytes / PEAK_BYTES_PER_S)
            if variant == "counts":
                checks = [certificate_holds(e16[lo:lo + qb], e16, store, k, thr, args.recall)
                          for lo in range(0, n, qb)]
                r["certificate_holds"] = all(h for h, _ in checks)
                r["certified_rows"] = sum(c for _, c in checks)
            results[f"{variant}_{store}"] = r
            print(json.dumps({f"{variant}_{store}": r}), flush=True)

    r, _ = bench(lambda: topk.topk_cosine(e, k, exact_above=thr, method="certified-bf16"),
                 n, device, args.reps)
    results["production_certified_bf16"] = {"s": r["median_s"], "qps": r["qps"]}
    flop = 2 * n * n * args.dim
    print(json.dumps({
        "n": n, "dim": args.dim, "k": k, "query_block": qb, "results": results,
        "matmul_tflops_at_max_f32": flop / results["max_f32"]["s"] / 1e12,
        "matmul_tflops_at_max_bf16": flop / results["max_bf16"]["s"] / 1e12,
        "peak_bytes_per_s": PEAK_BYTES_PER_S, **describe_card(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
