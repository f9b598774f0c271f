"""Nothing the benchmark runs imports JAX or the JAX package.

Top-level module names (the part before the first dot) are compared
whole: `video_fingerprint_tpu_torch`, the program, begins with the name of
the JAX package, `video_fingerprint_tpu`, and is allowed; the reference
may import neither.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import REPO

BENCH = REPO / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "video_fingerprint_tpu"}
PROGRAM = "video_fingerprint_tpu_torch"


def _sources(*parts: str):
    return sorted(p for part in parts for p in (BENCH / part).rglob("*.py")
                  if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path: Path) -> set:
    """Top-level names of every import in a file, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources("harness", "drivers", "reference", "metrics")
                         + [BENCH / "run.py", BENCH / "control.py"],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_benchmark_module_imports_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", _sources("reference"), ids=lambda p: p.name)
def test_benchmark_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)
    assert not top_level_imports(path) & FORBIDDEN


def test_benchmark_names_are_compared_whole():
    assert "video_fingerprint_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "video_fingerprint_tpu.models".split(".")[0] in FORBIDDEN


def test_benchmark_loads_no_jax_at_run_time():
    """The harness, the reference and the parts of the program a run drives,
    imported in a fresh process, leave no JAX module loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.harness.main, benchmark.control\n"
        "import benchmark.drivers.library_scan, benchmark.drivers.index_search\n"
        "import video_fingerprint_tpu_torch.inference.scanner\n"
        "import video_fingerprint_tpu_torch.inference.index\n"
        "from benchmark.harness.main import forbidden_modules\n"
        "print(forbidden_modules())\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
