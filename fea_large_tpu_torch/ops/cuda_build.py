"""Build the port's CUDA sources (fea_large_tpu_torch/csrc/*.cu) with nvcc.

Each source compiles on its own into a shared library with a plain C
interface, under build/fea_kernels/, named by a hash of the source, the
shared headers (csrc/*.cuh) and the flags, so a changed source rebuilds and
an unchanged one is reused. A failed build raises; nothing falls back.
Nothing is built at import: the modules that launch kernels call `load` at
their first launch, and `chip_smoke.py` calls `build_library` for every
source at once (one nvcc each, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fea_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict = {}


def _nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    path = shutil.which("nvcc")
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path is None and fallback.exists():
        path = str(fallback)
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library(source: Path) -> tuple[Path, float, str]:
    """Compile `source` into build/fea_kernels/ unless a library for the
    same source, headers and flags is there. Returns (path, build seconds
    (0 if reused), compiler log)."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib)
    return lib, seconds, log


def load(source: Path, signatures: dict) -> ctypes.CDLL:
    """The built library of `source`, loaded once, with `signatures`
    ({function: argtypes}) set and every function returning a C int (the
    CUDA error code of its launch)."""
    if source not in _LOADED:
        path, _, _ = build_library(source)
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[source] = lib
    return _LOADED[source]
