"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by `nvcc` into one shared library with a
plain C interface, which is loaded with `ctypes` (no PyTorch headers, so a
build takes seconds).  The library lands in `build/grtrace_torch_kernels/`
beside the package, named by a hash of the sources and flags: it is built
at first use and reused while the sources are unchanged.

Numerics: `-fmad=false`, no `--use_fast_math`, IEEE division and square
root (nvcc's defaults), so each kernel rounds exactly like its eager twin.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "grtrace_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the sources."""


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgrtrace_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the sources if their library is not built yet.

    Returns (library path, seconds spent compiling — 0.0 when the library
    already existed).  The compiler's output (ptxas register counts
    included) is kept in `<library>.log`.
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    lib.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    return lib, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library, with its C entry
    points' signatures declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.grt_fantasy_eqc_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
