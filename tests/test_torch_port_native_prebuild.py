"""The root conftest.py's prebuild of the JAX package's native libraries:
in the process that is not a pytest-xdist worker it builds both libraries
once, under build/jax_native.lock, before any worker collects; six
processes loading them at once afterwards all succeed; a worker's
pytest_configure does nothing."""

import importlib.util
import shutil
import subprocess
import sys
import types

import pytest

from tests.conftest import REPO_ROOT

_LOAD = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("loader", sys.argv[1])
module = importlib.util.module_from_spec(spec)
spec.loader.exec_module(module)
print(module.available())
"""


def _root_conftest():
    spec = importlib.util.spec_from_file_location("_vfp_root_conftest", REPO_ROOT / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def tree(tmp_path):
    """A copy of the two loaders and their C++ sources, with no library built."""
    (tmp_path / "video_fingerprint_tpu" / "utils").mkdir(parents=True)
    (tmp_path / "native").mkdir()
    for name in ("native", "native_decode"):
        shutil.copy(REPO_ROOT / "video_fingerprint_tpu" / "utils" / f"{name}.py",
                    tmp_path / "video_fingerprint_tpu" / "utils")
    for name in ("vfp_host.cc", "vfp_decode.cc"):
        shutil.copy(REPO_ROOT / "native" / name, tmp_path / "native")
    return tmp_path


def test_prebuild_then_six_concurrent_loads(tree, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the JAX loaders cannot build, and their tests skip")
    conftest = _root_conftest()
    monkeypatch.setattr(conftest, "REPO_ROOT", tree)
    conftest.pytest_configure(types.SimpleNamespace())
    libs = [tree / "native" / "libvfp_host.so", tree / "native" / "libvfp_decode.so"]
    assert all(lib.exists() for lib in libs)
    assert (tree / "build" / "jax_native.lock").exists()
    stamps = [lib.stat().st_mtime_ns for lib in libs]
    for name in ("native", "native_decode"):
        loader = tree / "video_fingerprint_tpu" / "utils" / f"{name}.py"
        procs = [subprocess.Popen([sys.executable, "-c", _LOAD, str(loader)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for _ in range(6)]
        outs = [p.communicate(timeout=300) for p in procs]
        assert [o.strip() for o, _ in outs] == ["True"] * 6, (name, outs)
    assert [lib.stat().st_mtime_ns for lib in libs] == stamps  # loaded, not rebuilt


def test_worker_does_not_build(monkeypatch):
    conftest = _root_conftest()
    calls = []
    monkeypatch.setattr(conftest, "prebuild_jax_native", calls.append)
    conftest.pytest_configure(types.SimpleNamespace(workerinput={"workerid": "gw0"}))
    assert calls == []
    conftest.pytest_configure(types.SimpleNamespace())
    assert calls == [conftest.REPO_ROOT]
