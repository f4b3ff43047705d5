"""Build and load the port's CUDA kernels.

Each kernel library is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds. Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a digest of
their sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. The first use builds; ``build_all`` builds every
library at once, one ``nvcc`` each, all started together.

A missing ``nvcc`` or a failed build raises: there is no fallback.
``BUILDS`` counts each library's builds and loads in this process
(``obs.guard.LibraryBuilds`` watches it: a run's later chunks must add
none).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, Tuple

_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build" / "repro_torch"
# headers every kernel shares: float32/bfloat16 access, the counter-hash
# noise (kernels/noise.py's twin), split TF32 products on the tensor cores
_SHARED = Path(__file__).resolve().parent / "csrc"
SHARED_HEADERS = (_SHARED / "dtypes.cuh", _SHARED / "noise.cuh", _SHARED / "tf32x3.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Library:
    """One shared library: its name, its ``.cu`` sources and the headers
    they include (part of the digest)."""
    name: str
    sources: Tuple[Path, ...]
    headers: Tuple[Path, ...] = ()

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in self.sources + self.headers:
            h.update(f.name.encode())
            h.update(f.read_bytes())
        return h.hexdigest()[:16]

    @property
    def path(self) -> Path:
        return BUILD_DIR / f"lib{self.name}-{self.digest()}.so"

    @property
    def log_path(self) -> Path:
        return self.path.with_suffix(".log")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels cannot be built")


def build_all(libs: Iterable[Library]) -> Dict[str, float]:
    """Build every library that is not built yet, all nvcc processes at
    once. Returns {name: seconds} for those built (0.0 if already there);
    raises with the compiler's output if any build fails."""
    libs = list(libs)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for lib in libs:
        if lib.path.is_file():
            continue
        tmp = lib.path.with_name(f"{lib.path.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, lib.sources)]
        procs[lib] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    times = {lib.name: 0.0 for lib in libs}
    failed = []
    for lib, (tmp, proc) in procs.items():
        _count(f"{lib.name} build")
        log, _ = proc.communicate()
        times[lib.name] = time.perf_counter() - t0
        lib.log_path.write_text(log)
        if proc.returncode != 0:
            failed.append(f"{lib.name} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib.path)    # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


_LOADED: Dict[Library, ctypes.CDLL] = {}
BUILDS: Dict[str, int] = {}     # "<name> build" / "<name> load" -> count


def _count(key: str) -> None:
    BUILDS[key] = BUILDS.get(key, 0) + 1


def load(lib: Library) -> ctypes.CDLL:
    """The loaded library, built first if needed. The sources are hashed
    once per process, at the first call: a launch pays a dict lookup."""
    if lib not in _LOADED:
        build_all([lib])
        _LOADED[lib] = ctypes.CDLL(str(lib.path))
        _count(f"{lib.name} load")
    return _LOADED[lib]
