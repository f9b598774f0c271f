"""Builds the JAX package's native libraries once, before pytest-xdist starts
its workers.

video_fingerprint_tpu/utils/native.py and native_decode.py compile
native/lib*.so with g++ in place at their first `available()` call and
remember a failed load for the rest of the process. tests/test_native.py and
tests/test_native_decode.py call it while they are collected, and under
`-n 6` every worker collects every file: in a fresh checkout six compilers
then write the same file at once, and a worker that loads a half-written
library skips the whole file. Here the process that is not a worker (the
controller, or a run without xdist) builds both libraries first, under the
file lock the port's native fixtures take (build/jax_native.lock), so the
workers find them built. The loaders are loaded by file path, without
importing their package (which imports jax). Where g++ or the libav headers
are missing, `available()` is False and the test files skip as before;
nothing here skips, deselects or changes a test.
"""

from __future__ import annotations

import fcntl
import importlib.util
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parent
LOADERS = ("native", "native_decode")


def prebuild_jax_native(repo_root: Path) -> dict:
    """Call `available()` once on each JAX native loader under repo_root,
    under repo_root/build/jax_native.lock; {loader: available}."""
    lock = repo_root / "build" / "jax_native.lock"
    lock.parent.mkdir(parents=True, exist_ok=True)
    built = {}
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            for name in LOADERS:
                path = repo_root / "video_fingerprint_tpu" / "utils" / f"{name}.py"
                spec = importlib.util.spec_from_file_location(f"_vfp_prebuild_{name}", path)
                module = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(module)
                built[name] = module.available()
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return built


def pytest_configure(config):
    if not hasattr(config, "workerinput"):
        prebuild_jax_native(REPO_ROOT)
