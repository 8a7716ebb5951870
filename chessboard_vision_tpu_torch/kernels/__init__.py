"""Hand-written CUDA kernels of the port: build at first use, bind with ctypes.

Each ``<name>.cu`` in this directory exports a plain C launcher. ``load``
compiles it with nvcc for sm_90a into ``_build/`` (git-ignored) under a
file name keyed on a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads in milliseconds. A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Sequence

KERNEL_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(KERNEL_DIR, "_build")
# Every kernel source of the port, by name (``<name>.cu``).
SOURCES = tuple(sorted(f[:-3] for f in os.listdir(KERNEL_DIR) if f.endswith(".cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuildResult(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time (0.0 when the library was already built)
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(name: str, source: Optional[str] = None) -> BuildResult:
    """Compile ``<name>.cu`` (or the file ``source``) into
    ``_build/lib<name>_<hash>.so`` unless an up-to-date library is already
    there."""
    src = source or os.path.join(KERNEL_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")
    if os.path.exists(lib):
        return BuildResult(lib, 0.0, "")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], capture_output=True, text=True
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return BuildResult(lib, seconds, proc.stdout + proc.stderr)


def build_all(names: Sequence[str]) -> Dict[str, BuildResult]:
    """``build`` every source at once: one nvcc process each, all started
    together, so the slowest source sets the wall time."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``<name>.cu``, once per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name).path)
    return _loaded[name]
