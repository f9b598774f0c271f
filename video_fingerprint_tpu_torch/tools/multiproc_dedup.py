"""The corpus-sharded dedup across processes, checked on every rank.

The port of tools/multihost_smoke_worker.py::run_dedup: the ring
`sharded_topk_cosine` (exact; certified at recall 0.7, so the repairs run;
certified-bf16 at 0.9) and the query search `sharded_topk_search` over a
corpus whose blocks live in different processes, then the bf16-resident
ring and the bf16-staged search in the quantized-query score domain. Every
rank checks the numpy oracle itself and that every rank got the same
answer, then prints "sharded dedup over W processes OK".

It joins the process group that torch.distributed.run describes:

    # on the CPU, two gloo ranks
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m video_fingerprint_tpu_torch.tools.multiproc_dedup --device cpu
    # one rank per card, NCCL
    python -m torch.distributed.run --standalone --nproc_per_node <cards> \\
        -m video_fingerprint_tpu_torch.tools.multiproc_dedup
    # two gloo ranks sharing one card (NCCL refuses two ranks on one GPU)
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m video_fingerprint_tpu_torch.tools.multiproc_dedup --device cuda:0 --backend gloo

Without the launcher it runs in one process over the platform's devices.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

N, DIM, K = 96, 32, 5
THRESHOLD = 0.9


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _complete_above(scores, idx, sims, thr: float, tol: float, what: str) -> None:
    """Every corpus row with oracle similarity >= thr is among the row's k."""
    for row in range(len(idx)):
        want = set(np.flatnonzero(sims[row] >= thr).tolist())
        got = {int(j) for s, j in zip(scores[row], idx[row]) if s >= thr - tol}
        _require(want <= got, f"{what}: row {row} misses {sorted(want - got)}")


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _bf16_rows(x: np.ndarray) -> np.ndarray:
    """The stored directions of x's bf16 rounding (round to nearest even)."""
    return _unit(torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def run_dedup(devices) -> list:
    """The checks of the JAX worker's run_dedup, on `devices` (this rank's);
    returns every result, for the cross-rank comparison."""
    from video_fingerprint_tpu_torch.ops.topk import (
        sharded_topk_cosine,
        sharded_topk_search,
        stage_sharded_corpus,
    )

    rng = np.random.default_rng(3)
    e = rng.normal(size=(N, DIM)).astype(np.float32)
    for a, b in ((0, 1), (40, 41), (70, 71)):  # planted near copies
        e[b] = 0.98 * e[a] + 0.2 * e[b]
    e = _unit(e)
    sims = e @ e.T
    oracle = np.sort(np.take_along_axis(sims, np.argsort(-sims, axis=1)[:, :K], axis=1),
                     axis=1)
    results = []

    def read(pair):
        out = tuple(t.cpu().numpy() for t in pair)
        results.append(out)
        return out

    for method, kwargs in (("exact", {}),
                           ("certified", {"recall_target": 0.7}),  # repairs forced
                           ("certified-bf16", {"recall_target": 0.7,
                                               "exact_above": THRESHOLD})):
        s, i = read(sharded_topk_cosine(e, K, devices=devices, method=method, **kwargs))
        if method == "certified-bf16":
            _complete_above(s, i, sims, THRESHOLD, 1e-5, method)
        else:
            err = float(np.abs(np.sort(s, axis=1) - oracle).max())
            _require(err <= 1e-5, f"ring {method}: scores off the oracle by {err}")

    q = _unit(rng.normal(size=(7, DIM)).astype(np.float32))
    qs, qi = read(sharded_topk_search(q, e, K, devices=devices, method="exact"))
    q_sims = q @ e.T
    q_oracle = np.take_along_axis(q_sims, np.argsort(-q_sims, axis=1)[:, :K], axis=1)
    err = float(np.abs(qs - q_oracle).max())
    _require(err <= 1e-5, f"query search: scores off the oracle by {err}")

    # bf16 residency: host-rounded staging, the ring's f32-norm cosine
    # rescale, and the quantized-query score domain
    eq = _bf16_rows(e)
    sims16 = eq @ eq.T
    s, i = read(sharded_topk_cosine(torch.from_numpy(e).to(torch.bfloat16), K,
                                    devices=devices, method="certified-bf16",
                                    exact_above=THRESHOLD, recall_target=0.7))
    _complete_above(s, i, sims16, THRESHOLD, 2e-5, "bf16-resident ring")
    live = np.isfinite(s)
    err = float(np.abs(s[live] - np.take_along_axis(sims16, i, axis=1)[live]).max())
    _require(err <= 2e-5, f"bf16-resident ring: score domain off by {err}")
    staged16 = stage_sharded_corpus(e, devices, torch.bfloat16)
    qq_sims = _bf16_rows(q) @ eq.T
    bs, bi = read(sharded_topk_search(q, staged16, K, method="certified-bf16",
                                      exact_above=THRESHOLD, recall_target=0.7))
    _complete_above(bs, bi, qq_sims, THRESHOLD, 2e-5, "bf16-staged search")
    live = np.isfinite(bs)
    err = float(np.abs(bs[live] - np.take_along_axis(qq_sims, bi, axis=1)[live]).max())
    _require(err <= 2e-5, f"bf16-staged search: score domain off by {err}")
    return results


def _same_on_every_rank(results, device) -> None:
    """Every rank's results equal rank 0's, bit for bit."""
    from video_fingerprint_tpu_torch.parallel.distributed import all_gather_stack

    for n, pair in enumerate(results):
        for x in pair:
            mine = torch.from_numpy(np.ascontiguousarray(x)).to(device)
            every = all_gather_stack(mine)
            _require(bool((every == every[0]).all()), f"result {n} differs between ranks")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the rank's card, LOCAL_RANK), cuda:<i>, or cpu")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")
    args = p.parse_args(argv)

    from video_fingerprint_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from video_fingerprint_tpu_torch.parallel.mesh import as_devices
    from video_fingerprint_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rank, world = maybe_initialize_distributed(device, args.backend)
    try:
        devices = as_devices(None, device)
        _same_on_every_rank(run_dedup(devices), devices[0])
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(f"sharded dedup over {world} processes OK (rank {rank}; exact+certified+bf16 "
          f"ring, query search, bf16-resident ring+staged)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
