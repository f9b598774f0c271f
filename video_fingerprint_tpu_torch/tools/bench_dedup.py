"""Large-scale dedup benchmark: top-k self-search over a synthetic corpus
of unit embeddings on the card.

Port of tools/bench_dedup.py, over the port's ops/topk.py (the exact and
certified methods, the ring-sharded `sharded_topk_cosine` over the
platform's devices or, with --ring, over one). It prints one JSON line,
{"metric", "value" (queries/s), "unit", "vs_baseline", ...}; the baseline
is numpy's all-pairs product and argpartition on the host over
--baseline_n rows, scaled by N (O(N^2) work).

The corpus is staged on the device once and every timed search reads it
from there, as a scan's embeddings already are. --planted puts a tenth of
the rows in near-duplicate clusters with cosines of 0.93-0.995, so the
thresholded verification has cross-row hits; --device_corpus draws the
corpus on the device (a torch.Generator) instead of on the host;
--corpus_dtype bf16 keeps it in bfloat16, and then every contract holds
for the stored (rounded) vectors. --verify runs the exact method once and
holds the timed method's results to its contract; --verify_sample checks
sampled rows against the host's float32 truth instead. A failed check
exits 1.

    python -m video_fingerprint_tpu_torch.tools.bench_dedup [--n 100000]
        [--k 20] [--method exact] [--exact_above 0.95] [--planted] [--verify]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from video_fingerprint_tpu_torch.ops import topk
from video_fingerprint_tpu_torch.parallel.mesh import platform_devices
from video_fingerprint_tpu_torch.tools.bench_common import describe_card, emit
from video_fingerprint_tpu_torch.utils import trace
from video_fingerprint_tpu_torch.utils.device import resolve_device

SLAB = 1 << 20      # rows drawn at a time on the device
SCORE_TOL = 5e-5    # score agreement between two search programs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline_n", type=int, default=4000,
                    help="corpus rows of the host numpy baseline (N^2 would not fit)")
    ap.add_argument("--method", default="auto", choices=list(topk.METHODS))
    ap.add_argument("--verify", action="store_true",
                    help="after timing, run method='exact' once and hold the timed "
                         "method's results to its contract")
    ap.add_argument("--verify_sample", type=int, default=0,
                    help="verify this many sampled rows against the host's float32 "
                         "truth instead (thresholded methods only)")
    ap.add_argument("--planted", action="store_true",
                    help="a tenth of the rows in planted near-duplicate clusters")
    ap.add_argument("--exact_above", type=float, default=None,
                    help="duplicate threshold of the relaxed certificate")
    ap.add_argument("--ring", action="store_true",
                    help="the ring-sharded path (sharded_topk_cosine) even on one device")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--query_block", type=int, default=topk.QUERY_BLOCK,
                    help="queries per tile")
    ap.add_argument("--device_corpus", action="store_true",
                    help="draw the corpus on the device instead of the host")
    ap.add_argument("--corpus_dtype", choices=("f32", "bf16"), default="f32",
                    help="bf16 keeps the corpus resident in bfloat16")
    return ap.parse_args(argv)


def planted_corpus(n: int, dim: int, seed: int = 0) -> np.ndarray:
    """Unit rows, the first n // 10 in n // 40 near-duplicate clusters: a
    base vector plus noise of scale s in [0.1, 0.4], so cosines land
    around 0.93-0.995 (a copy of tools/exp_topk_precision.py::make_corpus)."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, dim)).astype(np.float32)
    n_clusters = max(1, n // 40)
    rows = n // 10
    base = rng.normal(size=(n_clusters, dim)).astype(np.float32)
    which = rng.integers(0, n_clusters, size=rows)
    s = rng.uniform(0.1, 0.4, size=rows).astype(np.float32)[:, None]
    e[:rows] = base[which] + s * rng.normal(size=(rows, dim)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    return e


def host_corpus(args) -> np.ndarray:
    if args.planted:
        return planted_corpus(args.n, args.dim, args.seed)
    rng = np.random.default_rng(args.seed)
    e = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    return e / np.linalg.norm(e, axis=1, keepdims=True)


def device_corpus(args, device, dtype) -> torch.Tensor:
    """The corpus drawn on the device in slabs of SLAB rows, each stored in
    `dtype` as it is made; with --planted the clusters are built in the
    first slab, as planted_corpus builds them."""
    g = torch.Generator(device=device).manual_seed(args.seed)
    parts = []
    for lo in range(0, args.n, SLAB):
        x = torch.randn((min(SLAB, args.n - lo), args.dim), generator=g, device=device)
        if args.planted and lo == 0:
            n_clusters = max(1, args.n // 40)
            rows = min(args.n // 10, x.shape[0])
            base = torch.randn((n_clusters, args.dim), generator=g, device=device)
            which = torch.randint(0, n_clusters, (rows,), generator=g, device=device)
            s = 0.1 + 0.3 * torch.rand((rows, 1), generator=g, device=device)
            x[:rows] = base[which] + s * torch.randn((rows, args.dim), generator=g,
                                                     device=device)
        parts.append((x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).to(dtype))
    return torch.cat(parts)


def _require(cond: bool, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def to_host_f32(x, bf16: bool) -> np.ndarray:
    """Host truth in f32: for a bf16 corpus the stored (rounded) rows,
    renormalized, since every search reports cosines of the stored rows."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if bf16:
        x = x.to(torch.bfloat16)
    out = x.detach().to("cpu", torch.float32).numpy()
    if bf16:
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        out = out / np.where(norms > 0, norms, 1.0)
    return out


def verify_sample(args, e_host, s_m, i_m) -> str:
    """Complete above the threshold, and scores within SCORE_TOL, on
    sampled rows against the host's f32 truth (half the sample in the
    planted block)."""
    thr = args.exact_above
    _require(thr is not None, "--verify_sample is for the thresholded methods")
    vrng = np.random.default_rng(1)
    n_sample = min(args.verify_sample, args.n)
    if args.planted:
        block = max(1, args.n // 10)
        half = min(n_sample // 2, block)
        rows = np.unique(np.concatenate([
            vrng.choice(block, size=half, replace=False),
            vrng.choice(args.n, size=n_sample - half, replace=False)]))
    else:
        rows = vrng.choice(args.n, size=n_sample, replace=False)
    max_d, n_hits = 0.0, 0
    chunk = max(8, min(256, int(2e9 / (4 * args.n))))
    for lo in range(0, len(rows), chunk):
        sel = rows[lo:lo + chunk]
        truth = e_host[sel] @ e_host.T
        for r_local, r in enumerate(sel):
            want = np.flatnonzero(truth[r_local] >= thr)
            if len(want) > args.k:
                # the list is k-truncated: only hits above the k-th best
                # true score (+ the tolerance) must appear
                tw = truth[r_local][want]
                want = want[tw > np.sort(tw)[-args.k] + SCORE_TOL]
            got = set(i_m[r][s_m[r] >= thr - SCORE_TOL].tolist())
            missing = [int(j) for j in want if int(j) not in got]
            _require(not missing, (int(r), missing))
            n_hits += len(want)
            live = np.isfinite(s_m[r])
            d = np.abs(s_m[r][live] - truth[r_local][i_m[r][live]])
            max_d = max(max_d, float(d.max()) if d.size else 0.0)
    _require(max_d < SCORE_TOL, max_d)
    return (f"host-truth sample: complete above {thr} on {len(rows)} rows "
            f"({n_hits} hits); score delta {max_d:.2e}")


def verify_exact(args, s_m, i_m, s_x, i_x) -> str:
    """Strict: the score multisets equal exact's bit for bit. Threshold:
    every exact hit >= the threshold is among the timed method's
    candidates, and shared ids' scores agree within SCORE_TOL."""
    if args.exact_above is None:
        _require(np.array_equal(np.sort(s_m, 1), np.sort(s_x, 1)),
                 "score multisets differ from exact")
        return "strict: score multisets bit-equal to exact"
    thr = args.exact_above
    n_checked, max_d = 0, 0.0
    for lo in range(0, len(s_m), 65536):
        xs, xi = s_x[lo:lo + 65536], i_x[lo:lo + 65536]
        ms, mi = s_m[lo:lo + 65536], i_m[lo:lo + 65536]
        same_id = xi[:, :, None] == mi[:, None, :]
        hit_x = xs >= thr
        found = (same_id & (ms >= thr - SCORE_TOL)[:, None, :]).any(-1)
        missing = hit_x & ~found
        _require(not missing.any(), (lo + np.flatnonzero(missing.any(1))[:5],
                                     xi[missing][:5]))
        n_checked += int(hit_x.any(1).sum())
        live = same_id & np.isfinite(ms)[:, None, :]
        d = np.abs(ms[:, None, :] - xs[:, :, None])
        max_d = max(max_d, float(np.where(live, d, 0.0).max()))
    _require(max_d < SCORE_TOL, max_d)
    return (f"thresholded: complete above {thr} on {n_checked} rows with hits; "
            f"shared-id score delta {max_d:.2e}")


def run(args):
    """Time the search; returns (the result, the timed method's (scores,
    indices) and the host f32 corpus the truth is computed from)."""
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    bf16 = args.corpus_dtype == "bf16"
    dtype = torch.bfloat16 if bf16 else torch.float32
    topk.QUERY_BLOCK = args.query_block
    devices = platform_devices(device) if device.index is None else [device]
    multi = len(devices) > 1 or args.ring

    if args.device_corpus:
        full = device_corpus(args, device, dtype)
        e_host = None  # pulled after timing, for the baseline and the checks
    else:
        full = host_corpus(args)
        e_host = to_host_f32(full, bf16)
    if multi:
        e = topk.stage_sharded_corpus(full, devices, dtype)
    elif args.device_corpus:
        e = full
    else:
        e = topk.stage_corpus(full, device, dtype)

    def search(method):
        if multi:
            return topk.sharded_topk_cosine(e, args.k, devices, method=method,
                                            exact_above=args.exact_above)
        return topk.topk_cosine(e, args.k, method=method, exact_above=args.exact_above)

    def timed():
        t0 = time.perf_counter()
        s, i = search(args.method)
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0, s, i

    warm, _, _ = timed()
    repaired0 = trace.counter("topk.repaired_rows")
    times = []
    for _ in range(args.reps):
        dt, s_dev, i_dev = timed()
        times.append(dt)
    dt = float(np.median(times))
    qps = args.n / dt
    s_m, i_m = s_dev.cpu().numpy(), i_dev.cpu().numpy()

    if e_host is None:
        rows = args.n if args.verify_sample else min(args.baseline_n, args.n)
        e_host = to_host_f32(full[:rows], bf16)
    del full

    nb = min(args.baseline_n, args.n)
    eb = e_host[:nb]
    t0 = time.perf_counter()
    sims = eb @ eb.T
    idx = np.argpartition(-sims, args.k, axis=1)[:, :args.k]
    np.take_along_axis(sims, idx, axis=1)
    bt = time.perf_counter() - t0
    baseline_qps_at_n = nb / (bt * (args.n / nb))

    verified = None
    if args.verify_sample:
        verified = verify_sample(args, e_host, s_m, i_m)
    elif args.verify:
        s_x, i_x = search("exact")
        verified = verify_exact(args, s_m, i_m, s_x.cpu().numpy(), i_x.cpu().numpy())

    result = {
        "metric": f"dedup top-{args.k} search over {args.n}-video corpus"
                  + (" (corpus-sharded)" if multi else " (single card)"),
        "value": qps,
        "unit": "queries/sec",
        "vs_baseline": qps / baseline_qps_at_n,
        "search_ms": dt * 1e3,
        "warmup_s": warm,
        "method": args.method,
        "exact_above": args.exact_above,
        "corpus_dtype": args.corpus_dtype,
        "repaired_rows_per_search": (trace.counter("topk.repaired_rows") - repaired0)
                                     / args.reps,
        "verified": verified,
        "config": (("ring-sharded" if multi else "single card")
                   + f" top-k, method={args.method}, f32 scores (TF32 off)"
                   + (", bf16-resident corpus (contracts for the stored rounded rows)"
                      if bf16 else "")),
        **describe_card(device),
    }
    return result, (s_m, i_m), e_host


def main(argv=None) -> int:
    result, _, _ = run(parse_args(argv))
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
