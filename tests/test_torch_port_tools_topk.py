"""The port's top-k probes (video_fingerprint_tpu_torch/tools/exp_topk_*.py
and exp_wide_topk.py) against the JAX tools and the JAX package, on the CPU:

- `make_corpus` is bit-equal to the JAX tool's (tools/exp_topk_precision.py);
- at n = 4,096 and k = 20, the blocked exact two-stage equals the
  full-width top-k, indices equal, and both hold JAX
  topk_search(method="exact")'s indices with scores within 1e-5 (both f32
  products, summed in other orders);
- the strict certificate accepts the exact search's own output and
  rejects a planted swap (the k-th score replaced by a lower one of the
  row);
- the production probe's verify_strict / verify_thr return true on the
  exact result and false on a planted error;
- the three precisions' products: HIGHEST and HIGH (TF32 has no effect on
  the CPU) equal the f32 product, DEFAULT that of the bf16-rounded inputs;
- each probe runs end to end with --device cpu at a small n and prints its
  keys.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import exp_topk_precision as jax_precision
from video_fingerprint_tpu.ops.topk import topk_search as jax_topk_search
from video_fingerprint_tpu_torch.tools import (
    exp_topk_bf16sims,
    exp_topk_blocked,
    exp_topk_cert,
    exp_topk_precision,
    exp_topk_production,
    exp_wide_topk,
)

N, K, DIM = 4096, 20, 256


@pytest.fixture(autouse=True, scope="module")
def _cap_torch_threads():
    """Two torch threads per test worker: the tier-1 run's six workers
    share the machine's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    return exp_topk_precision.make_corpus(N, DIM)


@pytest.fixture(scope="module")
def exact(corpus):
    """The port's full-width exact top-k and the similarities."""
    e = torch.from_numpy(corpus)
    sims = exp_topk_precision.product(e, e, "HIGHEST")
    s, i = exp_topk_blocked.single(sims, K)
    return sims, s, i


@pytest.mark.parametrize("n, dim", [(N, DIM), (1000, 64), (39, 8)])
def test_make_corpus_is_the_jax_tools(n, dim):
    ours, ref = exp_topk_precision.make_corpus(n, dim), jax_precision.make_corpus(n, dim)
    assert ours.dtype == ref.dtype and np.array_equal(ours, ref)


@pytest.mark.parametrize("tile", [512, 2048, 4096])
def test_blocked_equals_exact_and_jax(corpus, exact, tile):
    sims, s, i = exact
    bs, bi = exp_topk_blocked.blocked(sims, K, tile)
    assert torch.equal(bi, i) and torch.equal(bs, s)
    ref_s, ref_i = (np.asarray(a) for a in jax_topk_search(jnp.asarray(corpus),
                                                           jnp.asarray(corpus), K,
                                                           method="exact"))
    assert np.array_equal(bi.numpy(), ref_i)
    assert float(np.abs(bs.numpy() - ref_s).max()) <= 1e-5


def test_certificate_accepts_exact_and_rejects_a_swap(exact):
    sims, s, _ = exact
    assert bool(exp_topk_cert.certify(sims, s, K).all())
    planted = s.clone()
    row = 7
    below = sims[row][sims[row] < s[row, K - 1]].max()  # the row's (k+1)-th score
    planted[row, K - 2] = below  # a returned score swapped for a lower one of the row
    planted[row] = planted[row].sort(descending=True).values
    ok = exp_topk_cert.certify(sims, planted, K)
    assert not bool(ok[row]) and int(ok.sum()) == N - 1


def test_production_verifiers(exact):
    _, s, i = exact
    s, i = s.numpy(), i.numpy()
    assert exp_topk_production.verify_strict(s.copy(), s)
    assert exp_topk_production.verify_thr(s.copy(), i.copy(), s, i, 0.95) == (True, -1)
    bad_s = s.copy()
    bad_s[3, 0] -= 1e-3  # row 3's best (itself, 1.0) moved
    assert not exp_topk_production.verify_strict(bad_s, s)
    assert exp_topk_production.verify_thr(bad_s, i, s, i, 0.95) == (False, 3)
    # a row with a planted near copy above the threshold loses it
    row = int(np.flatnonzero((s >= 0.95).sum(axis=1) >= 2)[0])
    dropped = s.copy()
    dropped[row, 1:] = np.sort(np.where(np.arange(K)[1:] == 1, 0.5, s[row, 1:]))[::-1]
    assert exp_topk_production.verify_thr(dropped, i, s, i, 0.95) == (False, row)
    # equal-score indices may swap (ties at the k-th place): not an error
    swapped = i.copy()
    swapped[5, 0] = (i[5, 0] + 1) % N
    assert exp_topk_production.verify_thr(s, swapped, s, i, 0.95) == (True, -1)


def test_precision_products(corpus):
    e = torch.from_numpy(corpus[:256])
    f32 = e @ e.t()
    assert torch.equal(exp_topk_precision.product(e, e, "HIGHEST"), f32)
    assert torch.equal(exp_topk_precision.product(e, e, "HIGH"), f32)
    r = e.to(torch.bfloat16).float()
    default = exp_topk_precision.product(e, e, "DEFAULT")
    assert default.dtype == torch.float32
    assert float((default - r @ r.t()).abs().max()) <= 1e-6
    assert 1e-4 < float((default - f32).abs().max()) < 2e-2  # the inputs' rounding
    stored = exp_topk_precision.product(e, e, "DEFAULT", out_dtype=torch.bfloat16)
    assert stored.dtype == torch.bfloat16
    assert float((stored.float() - default).abs().max()) <= 2 ** -8


def _run(module, argv, capsys):
    assert module.main(["--device", "cpu", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_precision_probe_runs(capsys):
    out = _run(exp_topk_precision, ["--n", "2048"], capsys)
    assert set(exp_topk_precision.PRECISIONS) <= set(out) and out["precisions"]
    for name in ("HIGH", "DEFAULT"):
        assert {"qps", "median_s", "max_abs_score_delta", "topk_index_agreement",
                "decision_mismatch@0.95", "decision_mismatch@0.99"} <= set(out[name])
    assert out["HIGH"]["max_abs_score_delta"] == 0.0  # no TF32 on the CPU


def test_blocked_probe_runs(capsys):
    out = _run(exp_topk_blocked, ["--n", "2048", "--tile", "512"], capsys)
    for name in ("maxonly", "single_topk", "blocked_exact", "approx_0.95"):
        assert out[name]["qps"] > 0
    assert out["blocked_equals_exact"] and out["blocked_max_score_delta"] == 0.0
    assert out["blocked_index_agreement"] == 1.0 and 0 < out["approx_recall_measured"] <= 1


def test_cert_probe_runs(capsys):
    out = _run(exp_topk_cert, ["--n", "2048"], capsys)
    assert out["exact"]["qps"] > 0
    for recall in exp_topk_cert.RECALLS:
        r = out[f"certified@{recall}"]
        assert r["cert_rows_exact"] and 0 <= r["cert_fail_frac"] <= 1
        assert {"blocks_failed", "cert_fail_rows", "effective_qps_with_rerun"} <= set(r)


def test_bf16sims_probe_runs(capsys):
    out = _run(exp_topk_bf16sims, ["--n", "2100", "--reps", "1"], capsys)
    assert out["n"] == 2048  # whole query blocks only
    for variant in ("max", "approx", "counts"):
        for store in ("f32", "bf16"):
            r = out["results"][f"{variant}_{store}"]
            assert r["qps"] > 0 and r["bytes_per_block"] > 0 and r["bound_s_per_block"] > 0
    for store in ("f32", "bf16"):
        assert out["results"][f"counts_{store}"]["certificate_holds"]
    assert out["results"]["max_bf16"]["bytes_per_block"] < out["results"]["max_f32"][
        "bytes_per_block"]
    assert out["results"]["production_certified_bf16"]["qps"] > 0


def test_production_probe_runs(capsys):
    out = _run(exp_topk_production, ["--n", "2048"], capsys)
    for recall in (0.95, 0.99):
        assert out[f"certified_strict@r{recall}"]["strict_exact"]
        assert out[f"certified_thr@r{recall}"]["thr_complete"]
        assert "first_bad_row" not in out[f"certified_thr@r{recall}"]


def test_wide_probe_runs(capsys):
    out = _run(exp_wide_topk, ["--n", "5000"], capsys)
    legs = [f"block{qb}_{stage}{warm}" for qb in (256, 1024) for stage in ("sims", "chunked")
            for warm in ("_warm", "")]
    legs += [f"exact_search_qb{qb}_4k{warm}" for qb in (256, 1024) for warm in ("_warm", "")]
    for name in ["health", *legs]:
        assert out[name]["ms"] > 0, name


def test_wide_chunked_topk_equals_exact(exact):
    sims, s, i = exact
    with exp_wide_topk.query_tile(256):
        cs, ci = exp_wide_topk.chunked_topk(sims, K)
    assert torch.equal(ci, i) and torch.equal(cs, s)
