"""The port stands alone: no module of video_fingerprint_tpu_torch imports jax,
the JAX package, ml_dtypes, cv2 or av at import time (the 3D model, the
index, the scan cache, the training modules, device augment, the native
host bindings, the multi-device modules and the tools among them, the
benchmark program and its legs too, which import nothing of the root
`tools/` either; importing the bindings builds nothing), and
chip_smoke.py refuses to run without a card."""

import subprocess
import sys

import pytest

from tests.conftest import REPO_ROOT

# cv2 and av are blocked: the port must import (and bucket clips) on a
# machine without OpenCV or PyAV; only decoding needs them.
_IMPORT_ALL = """
import pkgutil, sys
sys.modules["cv2"] = sys.modules["av"] = None
import video_fingerprint_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "video_fingerprint_tpu",
                                    "tools"))
print(len(names), bad)
assert len(names) >= 57, names
for name in ("models.cnn3d", "inference.index", "inference.scan_cache", "utils.device",
             "config", "ops.losses", "ops.metrics", "training.optim", "training.train_step",
             "training.trainer", "cli.train", "data.dataset", "data.augment", "data.pairs",
             "ops.device_augment", "utils.native", "utils.native_decode",
             "parallel.mesh", "parallel.distributed", "tools.multiproc_dedup",
             "tools.convert_checkpoint", "tools.export_torch_checkpoint",
             "tools.bench", "tools.bench_common", "tools.bench_headline",
             "tools.bench_torch_baseline", "tools.bench_scan_e2e", "tools.bench_train",
             "tools.bench_dedup", "utils.flops", "utils.synthetic"):
    assert pkg.__name__ + "." + name in names, name
from video_fingerprint_tpu_torch.utils import native, native_decode
assert not (native.LIBRARY.tried or native_decode.LIBRARY.tried)
bad += sorted(m for m in sys.modules if m.split(".")[0] == "ml_dtypes")
assert not bad, bad
from video_fingerprint_tpu_torch.data.preprocess import bucket_for_length
assert bucket_for_length(100, (32, 64, 128, 500)) == 128
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of jax, flax, the JAX package or the root
    tools/, anywhere in the file."""
    import ast

    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "video_fingerprint_tpu_torch.tools" in names  # the benchmark phase
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                   "video_fingerprint_tpu", "tools")]
    assert not bad, bad


def test_chip_smoke_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
