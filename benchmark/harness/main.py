"""One run of one cell: set-up, the measured window, the check, the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic kind picks its driver, `benchmark/drivers/<kind>.py`
(drivers/__init__.py lists what a driver defines). With `--trace 0`
the line's metrics are the cell's end-to-end metrics, taken by the host
clock; with `--trace 1` the window, cut to TRACED_SECONDS, runs under the
profiler and the metrics are the per-layer ones, each read by its own
file under metrics/.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` a
`breakdown`, and last `checks`: each number compared with its limit,
which also close standard error. A run without the cards its cell asks
for, or that finds JAX loaded once the window has closed, prints no line
and exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.harness import spec
from benchmark.harness.trace import Trace, Tracer, breakdown, busy_seconds

# a traced run measures at most this long: the profiler's trace of a longer
# search window (~90 kernels and ~200 host events a call) takes minutes to read
TRACED_SECONDS = 10.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "video_fingerprint_tpu")


@dataclass
class Reading:
    """What a per-layer metric's reader gets: the cell, the traced window and
    the work the window completed."""

    cell: spec.Cell
    trace: Trace
    work: dict


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def device_description(device: torch.device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, started: float, bench_dir: Optional[Path] = None) -> dict:
    """The result line of one run; `started` is the process's start on the
    host clock, from which set-up is counted."""
    cell = spec.load_cell(root, workload, bench_dir)
    bench_dir = bench_dir or root / spec.BENCH_DIR.name
    driver = spec.driver(bench_dir, cell)
    readers = spec.metric_readers(bench_dir, cell.per_layer) if trace else {}
    with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
        state = driver.setup(cell, seed, device, Path(tmp))
        tracer = Tracer(trace, device, Path(tmp))
        driver.instrument(state, tracer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - started
        with tracer.window():
            record = driver.measure(state, min(seconds, TRACED_SECONDS) if trace else seconds,
                                    tracer)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        numbers = driver.check(state, record, device, seed)
    metrics: Dict[str, dict] = {}
    line = {}
    description = device_description(device, cell.chips, peak)
    if trace:
        reading = Reading(cell=cell, trace=tracer.trace, work=driver.work(record, cell))
        for m in cell.per_layer:
            value = readers[m["name"]](reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        description["busy_s"] = busy_seconds(tracer.trace.ops)
        description["window_s"] = tracer.trace.window_s
        line["breakdown"] = breakdown(tracer.trace)
    else:
        measured = driver.end_to_end(record)
        measured["setup_s"] = setup_s
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    steps = np.asarray(record["steps"])
    print(f"window {record['window_s']:.3f} s, {len(steps)} steps of "
          f"{np.min(steps):.4f} / {np.median(steps):.4f} / {np.max(steps):.4f} s "
          f"(min / median / max)", file=sys.stderr)
    failed = int(sum(numbers[name] for name in numbers if name.startswith("missing_")))
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0
    return {"correct": correct, "attempted": record["attempted"], "failed": failed,
            "metrics": metrics, "device": description, **line, "checks": checks}


def main(argv=None, root: Optional[Path] = None, started: Optional[float] = None) -> int:
    args = parse_args(argv)
    started = time.perf_counter() if started is None else started
    root = root or spec.BENCH_DIR.parent
    chips = spec.load_cell(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    line = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), started)
    loaded = forbidden_modules()
    if loaded:
        print(f"modules that must not load were loaded: {loaded}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
