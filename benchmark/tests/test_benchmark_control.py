"""Each cell's control comes out as not correct.

On the CPU, at the small cells' sizes: the reference in float8 (scan cells)
or over TF32-rounded operands (the search) in the program's place fails at
least one of the cell's limits. On the card (`gpu`), the same at the
benchmark's own cells and sizes, for one seed; `benchmark/control.py` reads
three or more.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from conftest import REPO, TINY_CELLS
from benchmark.harness import spec
from benchmark.reference.control import fp8, tf32

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def _control(root, cell, device, tmp_path, seed):
    c = spec.load_cell(root, cell, root / "benchmark")
    return c, spec.driver(root / "benchmark", c).control(c, seed, device, tmp_path)


def _fails(cell, numbers):
    return [name for name, limit in cell.limits.items() if numbers[name] > limit]


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_benchmark_control_fails_small_cells(tiny_root, tmp_path, cell):
    c, numbers = _control(tiny_root, cell, torch.device("cpu"), tmp_path, 2**31 + 17)
    assert _fails(c, numbers), numbers


def test_benchmark_lower_precisions():
    x = torch.tensor([1.0, 0.3, -2.5e-3, 448.0, 0.0])
    assert torch.equal(fp8(torch.zeros(3)), torch.zeros(3))
    assert fp8(x)[3] == 448.0 and (fp8(x) - x).abs().max() > 0
    assert tf32(torch.tensor([1.0 + 2**-11])).item() == 1.0
    assert tf32(torch.tensor([1.0 + 2**-10])).item() == 1.0 + 2**-10
    assert tf32(torch.tensor([1.0 + 3 * 2**-11])).item() == 1.0 + 2**-9


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_benchmark_control_fails_on_the_card(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c, numbers = _control(REPO, cell, torch.device("cuda"), Path(tmp_path), 2**31 + 19)
    assert _fails(c, numbers), numbers
