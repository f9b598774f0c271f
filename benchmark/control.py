"""The control of a cell: the reference one precision step below, in the
program's place, judged by the cell's own comparison.

    python3 benchmark/control.py --workload <cell> --seeds <n>[,<n>...]

The cell's driver (`benchmark/drivers/<kind>.py`) computes it: for a scan
the reference's embeddings with every product's operands rounded to
float8 e4m3 (reference/control.py) and the reference grouping of them;
for the search the reference's exact search over operands rounded to
TF32, over the first `check_calls` batches. Each seed prints one JSON
line: the numbers the cell compares, beside the cell's limits. The benchmark's own runs
never run this; it reads the upper end of each limit, on the chip at the
cell's size (and in benchmark/tests at a small one).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    cell = spec.load_cell(ROOT, args.workload)
    device = torch.device(args.device)
    control = spec.driver(ROOT / "benchmark", cell).control
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="control-") as tmp:
            numbers = control(cell, seed, device, Path(tmp))
        print(json.dumps({"workload": cell.name, "seed": seed, "control": numbers,
                          "limits": cell.limits}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
