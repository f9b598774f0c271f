"""Build the port's native sources and load them with ctypes.

Two kinds of source go through here, each into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

- the CUDA kernels under csrc/, compiled by nvcc on first use:

      nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
           -Xcompiler -fPIC <name>.cu -o build/vfp_torch_kernels/<name>-<hash>.so

  A failed build raises; nothing falls back.
- the host C++ sources under native/ (the JAX package's, unchanged),
  compiled by g++ with that package's flags into build/vfp_torch_native/
  and loaded through `HostLibrary`. A missing compiler, header or library
  leaves the library unavailable with the reason in `HostLibrary.error`,
  and its callers take the cv2 path, as the JAX package's do. Nothing is
  written into native/, where that package builds its own libraries.

Each library is named by a hash of its source, flags and libraries, so an
edited source is rebuilt and an unchanged one reused; it is written to a
temporary file and moved into place, so processes building at once do not
race.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "vfp_torch_kernels"
NATIVE_SRC = REPO_ROOT / "native"
HOST_BUILD_DIR = REPO_ROOT / "build" / "vfp_torch_native"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -Xptxas=-v only reports registers, shared memory and spills per kernel.
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """The compiler is missing or refused a source."""


class Recipe(NamedTuple):
    """How one source becomes a library: `libs` follow the source on the
    command line, as the linker needs; compiler "nvcc" is the toolkit's
    (`nvcc_path`)."""

    compiler: str
    source: Path
    flags: Tuple[str, ...]
    libs: Tuple[str, ...]
    out_dir: Path


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds ($CUDA_HOME, $CUDA_PATH, PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME is None or not nvcc.exists():
        raise KernelBuildError("nvcc not found (set CUDA_HOME)")
    return str(nvcc)


def cuda_recipe(name: str) -> Recipe:
    return Recipe("nvcc", CSRC / f"{name}.cu", (*ARCH_FLAGS, *NVCC_FLAGS), (), BUILD_DIR)


def host_recipe(name: str, flags: Iterable[str], libs: Iterable[str] = ()) -> Recipe:
    return Recipe("g++", NATIVE_SRC / f"{name}.cc", tuple(flags), tuple(libs), HOST_BUILD_DIR)


def library_path(recipe: Recipe) -> Path:
    digest = hashlib.sha256(recipe.source.read_bytes())
    digest.update(" ".join([*recipe.flags, "|", *recipe.libs]).encode())
    return recipe.out_dir / f"{recipe.source.stem}-{digest.hexdigest()[:16]}.so"


def _start(recipe: Recipe):
    """Start the compiler unless the library exists; returns (library
    path, None or (process, temporary output, command))."""
    lib = library_path(recipe)
    if lib.exists():
        return lib, None
    recipe.out_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    compiler = nvcc_path() if recipe.compiler == "nvcc" else recipe.compiler
    cmd = [compiler, *recipe.flags, str(recipe.source), "-o", str(tmp), *recipe.libs]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    except OSError as exc:
        raise KernelBuildError(f"{' '.join(cmd)}: {exc}") from exc
    return lib, (proc, tmp, cmd)


def build_recipes(recipes: Iterable[Recipe]) -> Dict[str, str]:
    """Compile every recipe at once (one compiler each, all started
    together) and return {source stem: compiler output}. Raises on any
    failure."""
    started = {r.source.stem: _start(r) for r in recipes}
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
        raise KernelBuildError("build failed:\n" + "\n".join(failures))
    return logs


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named csrc/ source at once; {name: nvcc output}."""
    return build_recipes([cuda_recipe(n) for n in names])


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built at first use."""
    with _lock:
        if name not in _loaded:
            recipe = cuda_recipe(name)
            build_recipes([recipe])
            _loaded[name] = ctypes.CDLL(str(library_path(recipe)))
        return _loaded[name]


class HostLibrary:
    """native/<name>.cc, built by g++ and loaded at the first `load()`,
    which `bind` then gives its ctypes signatures. When it cannot be built
    or loaded, `load()` returns None and `error` says why; it is tried
    once per process."""

    def __init__(self, name: str, flags: Iterable[str], libs: Iterable[str] = (),
                 bind: Callable[[ctypes.CDLL], None] = lambda lib: None):
        self.recipe = host_recipe(name, flags, libs)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.tried = False
        self.error = ""

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self.tried:
                self.tried = True
                try:
                    build_recipes([self.recipe])
                    lib = ctypes.CDLL(str(library_path(self.recipe)))
                except (KernelBuildError, OSError) as exc:
                    self.error = str(exc)
                else:
                    self._bind(lib)
                    self._lib = lib
            return self._lib
