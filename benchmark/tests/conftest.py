"""Small cells declared as data only, for the benchmark's CPU tests.

`tiny_root` copies the benchmark folder and BENCHMARK.json into a temporary
checkout and adds configurations, mixes, limits and workload entries of
its own, the way a later change adds a cell: new files and entries, no
edit to a file that is there. The cells run on the CPU through
harness/main.py::run_cell at widths and sizes a test run can hold.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CONFIGS = {
    "tiny-attention": {"model_type": "attention", "spatial_dim": 16, "temporal_dim": 32,
                       "embedding_dim": 32, "num_attention_blocks": 1, "num_heads": 8,
                       "frame_size": 16, "max_frames": 24, "precision": "bf16",
                       "fold_batchnorm": True},
    "tiny-cnn3d": {"model_type": "3d", "embedding_dim": 32, "frame_stride": 4, "clip_length": 16,
                   "frame_size": 16, "precision": "bf16", "fold_batchnorm": True},
}
COPIES = {"share": 0.1, "byte_share": 0.5, "trim": [0.05, 0.15]}
TINY_MIXES = {
    "tiny-attn-scan": {"kind": "library_scan", "videos": 40, "batch_size": 8, "threshold": 0.99,
                       "lengths": [{"share": 0.7, "source_frames": [30, 90]},
                                   {"share": 0.3, "source_frames": [10, 23]}],
                       "copies": COPIES, "check_videos": 30},
    "tiny-cnn3d-scan": {"kind": "library_scan", "videos": 30, "batch_size": 8, "threshold": 0.99,
                        "lengths": [{"share": 0.7, "source_frames": [161, 400]},
                                    {"share": 0.3, "source_frames": [10, 16]}],
                        "copies": COPIES},
    "tiny-search": {"kind": "index_search", "index_rows": 5000, "queries_per_call": 64,
                    "query_batches": 8, "planted": {"share": 0.1, "cosine": [0.995, 0.999]},
                    "distractors": {"share": 0.1, "cosine": [0.95, 0.985]}, "k": 20,
                    "threshold": 0.99, "check_calls": 4},
}
# set as the cells' are: above the program's readings at these sizes on the
# CPU (gap 0.003 attention, 0.0008 3D; scores equal, rows 3e-7), below the
# controls' (0.36, 0.069; 2.4e-4, 1.5e-4)
TINY_LIMITS = {
    "tiny-attn-scan": {"embedding_gap": 0.03, "group_mismatch": 0, "missing_videos": 0},
    "tiny-cnn3d-scan": {"embedding_gap": 0.01, "group_mismatch": 0, "missing_videos": 0},
    "tiny-search": {"score_gap": 1.5e-5, "row_gap": 1.5e-5, "group_mismatch": 0,
                    "missing_queries": 0},
}
TINY_CELLS = {"tiny-attn-scan": "tiny-attention", "tiny-cnn3d-scan": "tiny-cnn3d",
              "tiny-search": "tiny-attention"}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=2) + "\n")


def make_tiny_root(dest: Path) -> Path:
    """A checkout holding the benchmark and the tiny cells; returns its root."""
    bench = dest / "benchmark"
    shutil.copytree(REPO / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, config in TINY_CONFIGS.items():
        _write(bench / "configs" / f"{name}.json", config)
        spec["configs"].append({"name": name, "source": "a test's", "reduced": [],
                                "file": f"benchmark/configs/{name}.json", "why": "a test's"})
    for cell, config in TINY_CELLS.items():
        _write(bench / "traffic" / f"{cell}.json", TINY_MIXES[cell])
        _write(bench / "limits" / f"{cell}.json", TINY_LIMITS[cell])
        spec["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                                  "why": "a test's"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" not in metric:
            continue
        kinds = {"search": ["tiny-search"], "scan": ["tiny-attn-scan", "tiny-cnn3d-scan"]}
        moves = metric.get("moves", metric["name"])
        metric["workloads"] += kinds["search" if "search" in moves else "scan"]
    _write(dest / "BENCHMARK.json", spec)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("checkout"))
