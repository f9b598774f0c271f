"""The "index_search" kind: the scan CLI's `--against`, one caller in a closed loop.

The mix (`benchmark/traffic/<name>.json`) gives `index_rows` unit
fingerprints in an index, searched by `query_batches` batches of
`queries_per_call` new fingerprints each; a `planted.share` of each batch
lies at a cosine in `planted.cosine` to an index row, a
`distractors.share` at one in `distractors.cosine` (the same number in
every batch, at evenly spaced cosines). `k` and `threshold` are the
call's; `check_calls` calls are checked.

Each call is `FingerprintScanner.find_duplicates_against(batch, index,
threshold, k)`: a batch of new fingerprints searched against a
`FingerprintIndex` held on the card, as `cli/scan.py --against` calls it
after a scan. The model is loaded, as the CLI loads it, and never run.

Set-up draws the index and the query batches, builds the index with a
path and a file hash per row, as a saved index holds them, and makes
three calls: the first stages the corpus on the card.

The check, after the window: a seeded sample of the calls, each query's
top-k scores and rows, and its group, against the reference's exact
search (float32, TF32 off) of the same queries over the same rows. The
scores and rows are what `FingerprintIndex.search` returned inside the
call, found by the query they answer, however many searches the call
made; a query that no search of its call answered is missing. The
control (`control`) searches TF32-rounded operands in the program's place.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.traffic import evenly
from benchmark.reference import search as ref_search
from benchmark.reference import weights
from benchmark.reference.control import tf32
from benchmark.reference.models import exact_float32

WARMUP_CALLS = 3


@dataclass
class SearchTraffic:
    index: np.ndarray  # (N, D) float32 unit rows
    batches: List[np.ndarray]  # (Q, D) float32 unit queries per call
    planted: List[Dict[int, int]]  # per batch: query row -> index row it was planted at


def _near(rows: torch.Tensor, cosines: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Unit vectors at the given cosines to `rows` (unit): c r + sqrt(1 -
    c^2) u, u a random unit vector orthogonal to r."""
    u = torch.randn(rows.shape, generator=gen, device=rows.device)
    u = u - (u * rows).sum(dim=1, keepdim=True) * rows
    u = u / torch.linalg.vector_norm(u, dim=1, keepdim=True)
    c = cosines[:, None]
    return c * rows + torch.sqrt(1 - c * c) * u


def build_search(mix: dict, config: dict, seed: int, device: torch.device) -> SearchTraffic:
    """The index and the query batches of an "index_search" mix."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng([seed, 3])
    N, D, Q = mix["index_rows"], config["embedding_dim"], mix["queries_per_call"]
    index = torch.randn((N, D), generator=gen, device=device)
    index /= torch.linalg.vector_norm(index, dim=1, keepdim=True)
    n_planted = int(round(Q * mix["planted"]["share"]))
    n_distract = int(round(Q * mix["distractors"]["share"]))
    n_batches = mix["query_batches"]
    cos_planted = evenly(*mix["planted"]["cosine"], n_planted)
    cos_distract = evenly(*mix["distractors"]["cosine"], n_distract)
    queries = torch.randn((n_batches * Q, D), generator=gen, device=device)
    queries /= torch.linalg.vector_norm(queries, dim=1, keepdim=True)
    planted: List[Dict[int, int]] = []
    near_rows, near_cos, near_at = [], [], []
    for b in range(n_batches):
        rows = rng.choice(Q, n_planted + n_distract, replace=False)
        targets = rng.choice(N, n_planted + n_distract, replace=False)
        planted.append({int(r): int(t) for r, t in zip(rows[:n_planted], targets[:n_planted])})
        near_at.append(b * Q + rows)
        near_rows.append(targets)
        near_cos.append(np.concatenate([rng.permutation(cos_planted),
                                        rng.permutation(cos_distract)]))
    at = torch.from_numpy(np.concatenate(near_at)).to(device)
    targets = torch.from_numpy(np.concatenate(near_rows)).to(device)
    cos = torch.from_numpy(np.concatenate(near_cos)).to(device=device, dtype=torch.float32)
    queries[at] = _near(index[targets], cos, gen)
    host_q = queries.cpu().numpy()
    return SearchTraffic(index=index.cpu().numpy(),
                         batches=[host_q[b * Q:(b + 1) * Q] for b in range(n_batches)],
                         planted=planted)


def inputs(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The index rows, the query batches and a checkpoint for the scanner."""
    config, mix = cell.config, cell.traffic
    model_path = tmpdir / "model.pth"
    gen = torch.Generator(device=device).manual_seed(seed)
    weights.save_pth(weights.seeded_state_dict(config, gen), config, model_path)
    data = build_search(mix, config, seed, device)
    paths = [[f"query/{b:05d}_{q:03d}.mp4" for q in range(queries.shape[0])]
             for b, queries in enumerate(data.batches)]
    return {"config": config, "mix": mix, "data": data, "paths": paths,
            "model_path": model_path}


def setup(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    from video_fingerprint_tpu_torch.inference.index import FingerprintIndex
    from video_fingerprint_tpu_torch.inference.scanner import FingerprintScanner

    state = inputs(cell, seed, device, tmpdir)
    config, data = state["config"], state["data"]
    index = FingerprintIndex(dim=config["embedding_dim"], device=device.type)
    index.add(data.index, [{"path": f"index/video_{i:07d}.mp4", "file_hash": f"{i:032x}"}
                           for i in range(data.index.shape[0])])
    batches = [{path: {"embedding": queries[q], "path": path, "file_hash": f"{b:05d}:{q:03d}"}
                for q, path in enumerate(paths)}
               for b, (queries, paths) in enumerate(zip(data.batches, state["paths"]))]
    scanner = FingerprintScanner(str(state["model_path"]), device=device.type,
                                 bf16=config["precision"] == "bf16",
                                 optimize=config["fold_batchnorm"])
    state.update(index=index, batches=batches, scanner=scanner, searches=[])
    search = index.search

    def recorded(queries, k=20, exact_above=None):
        scores, idx = search(queries, k=k, exact_above=exact_above)
        state["searches"].append((queries, scores, idx))
        return scores, idx

    index.search = recorded  # keeps what each call's searches returned, for the check
    for b in range(WARMUP_CALLS):
        call(state, b % len(batches))
    return state


def instrument(state: dict, tracer) -> None:
    """Nothing to hook: the spans around each call are measure's."""


def call(state: dict, batch: int):
    """One `--against` call: (its groups, the searches it made)."""
    state["searches"] = []
    groups = state["scanner"].find_duplicates_against(
        state["batches"][batch], state["index"], state["mix"]["threshold"], k=state["mix"]["k"])
    return groups, state["searches"]


def measure(state: dict, seconds: float, tracer) -> dict:
    calls, latencies = [], []
    n = len(state["batches"])
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        b = len(calls) % n
        t0 = time.perf_counter()
        with tracer.span("bench.find_duplicates_against"):
            groups, searches = call(state, b)
        latencies.append(time.perf_counter() - t0)
        calls.append((b, [[item["path"] for item in g] for g in groups], searches))
    window_s = time.perf_counter() - start
    q = state["mix"]["queries_per_call"]
    return {"calls": calls, "steps": latencies, "window_s": window_s,
            "attempted": len(calls) * q}


def end_to_end(record: dict) -> Dict[str, float]:
    q = record["attempted"]
    return {"search_queries_per_s": q / record["window_s"],
            "search_p95_ms": float(np.percentile(record["steps"], 95)) * 1e3}


def sample_calls(record: dict, mix: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 4])
    n = len(record["calls"])
    return np.sort(rng.choice(n, min(mix["check_calls"], n), replace=False))


def release(state: dict, device: torch.device) -> None:
    state["scanner"] = state["index"] = state["batches"] = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def answers(queries: np.ndarray, searches) -> List:
    """Per query of a call, the (scores, rows) that one of the call's
    searches returned for it, found by the query itself, or None."""
    found = {}
    for searched, scores, rows in searches:
        for q, s, r in zip(np.asarray(searched, np.float32), scores, rows):
            found.setdefault(q.tobytes(), (s, r))
    return [found.get(q.tobytes()) for q in np.asarray(queries, np.float32)]


def compare(state: dict, sampled: List[tuple], device: torch.device) -> Dict[str, float]:
    """The numbers judged over the sampled calls, each (batch, groups, the
    (scores, rows) answering each of its queries or None): the widest gap
    between a returned score and the reference's score of the same rank,
    the widest gap between the reference's score of a returned row and
    that of the same rank (a row that is not among the true k best),
    queries that no search answered, and queries whose matches at or above
    the threshold differ from the reference's."""
    mix, data = state["mix"], state["data"]
    k, threshold = mix["k"], mix["threshold"]
    corpus = torch.from_numpy(data.index).to(device)
    score_gap = row_gap = 0.0
    mismatched = missing = 0
    for b, groups, answered in sampled:
        queries = torch.from_numpy(data.batches[b]).to(device)
        ref_s, ref_i = ref_search.exact_topk(queries, corpus, k)
        ref_s, ref_i = ref_s.cpu().numpy(), ref_i.cpu().numpy()
        have = [q for q, a in enumerate(answered)
                if a is not None and np.shape(a[0]) == ref_s[q].shape == np.shape(a[1])]
        missing += len(answered) - len(have)
        if have:
            scores = np.stack([answered[q][0] for q in have])
            rows = np.stack([answered[q][1] for q in have])
            score_gap = max(score_gap, float(np.abs(scores - ref_s[have]).max()))
            with exact_float32():
                picked = torch.from_numpy(rows).to(device)
                rescored = (corpus[picked] * queries[have][:, None, :]).sum(dim=2).cpu().numpy()
            row_gap = max(row_gap, float(np.abs(rescored - ref_s[have]).max()))
        got = {g[0]: set(g[1:]) for g in groups}
        for q, path in enumerate(state["paths"][b]):
            want = {f"index/video_{int(j):07d}.mp4"
                    for s, j in zip(ref_s[q], ref_i[q]) if s >= threshold}
            mismatched += got.get(path, set()) != want
    return {"score_gap": score_gap, "row_gap": row_gap, "group_mismatch": mismatched,
            "missing_queries": missing}


def check(state: dict, record: dict, device: torch.device, seed: int) -> Dict[str, float]:
    batches = state["data"].batches
    sampled = [(b, groups, answers(batches[b], searches))
               for b, groups, searches in (record["calls"][c]
                                           for c in sample_calls(record, state["mix"], seed))]
    release(state, device)
    return compare(state, sampled, device)


def work(record: dict, cell) -> dict:
    mix = cell.traffic
    return {"calls": len(record["calls"]), "queries_per_call": mix["queries_per_call"],
            "index_rows": mix["index_rows"], "dim": cell.config["embedding_dim"], "k": mix["k"]}


def control(cell, seed: int, device: torch.device, tmpdir: Path) -> dict:
    """The cell's numbers with the reference's exact search over TF32-rounded
    operands in the program's place, over the first `check_calls` batches."""
    state = inputs(cell, seed, device, tmpdir)
    mix, data = state["mix"], state["data"]
    corpus = tf32(torch.from_numpy(data.index).to(device))
    sampled = []
    for b in range(min(mix["check_calls"], len(data.batches))):
        scores, rows = ref_search.exact_topk(tf32(torch.from_numpy(data.batches[b]).to(device)),
                                             corpus, mix["k"])
        scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        groups = [[path] + [f"index/video_{int(j):07d}.mp4"
                            for s, j in zip(scores[q], rows[q]) if s >= mix["threshold"]]
                  for q, path in enumerate(state["paths"][b])]
        sampled.append((b, [g for g in groups if len(g) > 1], list(zip(scores, rows))))
    t0 = time.perf_counter()
    numbers = compare(state, sampled, device)
    return {**numbers, "reference_s": time.perf_counter() - t0}
