"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is compiled on first use into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/vfp_torch_kernels/<name>-<hash>.so <name>.cu

The library lands in `build/vfp_torch_kernels/` beside the package, named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vfp_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v only reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH, PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return str(nvcc)


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists; returns
    (library path, None or (process, temporary output, command))."""
    lib = _library_path(name)
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS,
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return lib, (proc, tmp, cmd)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source at once (one nvcc each, all started
    together) and return {name: compiler output}. Raises on any failure."""
    started = {n: _start(n) for n in names}
    logs: Dict[str, str] = {}
    failures = []
    for name, (lib, job) in started.items():
        if job is None:
            logs[name] = f"cached: {lib.name}"
            continue
        proc, tmp, cmd = job
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"{' '.join(cmd)}\n{out}")
            continue
        os.replace(tmp, lib)
    if failures:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _loaded:
            build([name])
            _loaded[name] = ctypes.CDLL(str(_library_path(name)))
        return _loaded[name]
