"""Whole runs of cells declared only as data, on the CPU, and the entry's refusals."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO, TINY_CELLS
from benchmark.harness import main

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(root, cell, trace=False, seed=2**31 + 101, seconds=0.5):
    return main.run_cell(root, cell, seed, seconds, trace, CPU, time.perf_counter(),
                         root / "benchmark")


def _digest(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_benchmark_cell_declared_as_data_runs(tiny_root, cell):
    """A cell added as files and entries only runs through the harness, its
    line has the contract's keys in order, and nothing of the benchmark as
    committed changed."""
    before = _digest(REPO / "benchmark")
    line = _run(tiny_root, cell)
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    reported = {m["name"] for m in spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
    assert set(line["metrics"]) == reported and "setup_s" in reported
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)
    assert _digest(REPO / "benchmark") == before


def test_benchmark_traced_line(tiny_root):
    line = _run(tiny_root, "tiny-attn-scan", trace=True)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device trace on the CPU: only what the host clock gives is read
    assert set(line["metrics"]) <= {"mfu.scan"}


def test_benchmark_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "attn-library-long",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_benchmark_jax_loaded_fails_the_run(monkeypatch, tiny_root):
    monkeypatch.setitem(sys.modules, "jax", object())
    assert main.forbidden_modules() == ["jax"]


TOY_DRIVER = '''"""A kind of traffic added as one file: a matrix product in a closed loop."""
import time

import torch


def setup(cell, seed, device, tmpdir):
    gen = torch.Generator(device=device).manual_seed(seed)
    n = cell.traffic["size"]
    return {"a": torch.randn((n, n), generator=gen, device=device)}


def instrument(state, tracer):
    pass


def measure(state, seconds, tracer):
    steps, start = [], time.perf_counter()
    while time.perf_counter() - start < seconds:
        t0 = time.perf_counter()
        state["out"] = state["a"] @ state["a"]
        steps.append(time.perf_counter() - t0)
    return {"steps": steps, "window_s": time.perf_counter() - start, "attempted": len(steps)}


def end_to_end(record):
    return {"toy_products_per_s": len(record["steps"]) / record["window_s"]}


def check(state, record, device, seed):
    want = state["a"].double() @ state["a"].double()
    return {"toy_gap": float((state["out"].double() - want).abs().max())}


def work(record, cell):
    return {}


def control(cell, seed, device, tmpdir):
    return {"toy_gap": 1.0}
'''


def test_benchmark_new_kind_added_as_files_runs(tmp_path):
    """A kind of traffic the benchmark did not have (its driver file, a mix,
    a limit, a workload entry and its end-to-end metric) runs through the
    harness as committed, with no edit to a file that is there."""
    from conftest import make_tiny_root

    before = _digest(REPO / "benchmark")
    root = make_tiny_root(tmp_path)
    bench = root / "benchmark"
    (bench / "drivers" / "toy_matmul.py").write_text(TOY_DRIVER)
    (bench / "traffic" / "toy.json").write_text(json.dumps({"kind": "toy_matmul", "size": 32}))
    (bench / "limits" / "toy-cell.json").write_text(json.dumps({"toy_gap": 1e-3}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "toy-cell", "config": "tiny-attention", "traffic": "toy",
                              "chips": 1, "why": "a test's"})
    spec["end_to_end"].append({"name": "toy_products_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": ["toy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = _run(root, "toy-cell")
    assert list(line) == KEYS and line["correct"] is True
    assert set(line["metrics"]) == {"toy_products_per_s", "setup_s"}
    assert _digest(REPO / "benchmark") == before
