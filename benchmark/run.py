"""The benchmark of the PyTorch/CUDA fingerprint system, one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for (BENCHMARK.json). Every build and kernel cache goes to a fixed
directory inside the checkout (build/), so only a checkout's first run
compiles. harness/main.py says what a run prints.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.main import main as run

    return run(root=ROOT, started=STARTED)


if __name__ == "__main__":
    sys.exit(main())
