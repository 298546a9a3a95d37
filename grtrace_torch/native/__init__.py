"""The host-side CSV serializer in C++, loaded with ctypes — the port's copy
of `grtrace.native` (csvio.cpp writes the same bytes).

The library is compiled with g++ at first use into
`build/grtrace_torch_native/` beside the package (ignored by git), named by
a hash of the source and flags.  Where no g++ is found, or it fails, every
entry returns False and `io/artifacts.py` writes the file with its
pure-Python writer instead.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csvio.cpp"
BUILD_DIR = SOURCE.parent.parent.parent / "build" / "grtrace_torch_native"
FLAGS = ("-O3", "-shared", "-fPIC")

_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / f"libgrtcsv_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def load():
    """The loaded library, built if needed; None without a working g++."""
    lib_path = library_path()
    if not lib_path.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            return None
        os.replace(tmp, lib_path)  # atomic: a concurrent build sees all
    lib = ctypes.CDLL(str(lib_path))
    lib.grt_write_photon_csv.restype = ctypes.c_int
    lib.grt_write_photon_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _F64, _F64, _F64,
        ctypes.POINTER(ctypes.c_int32), _F64, _F64, _F64]
    lib.grt_write_sampled_csv.restype = ctypes.c_int
    lib.grt_write_sampled_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _F64, _F64]
    return lib


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a, ctype=ctypes.c_double):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def write_photon_csv(path, h, w, final_r, final_th, final_ph, cls, heading,
                     p0, alpha0) -> bool:
    """photon_data.csv through the native writer; False when it is not
    available or failed."""
    lib = load()
    if lib is None:
        return False
    arrays = [_f64(a) for a in (final_r, final_th, final_ph)]
    cls32 = np.ascontiguousarray(cls, dtype=np.int32)
    rest = [_f64(a) for a in (heading, p0, alpha0)]
    rc = lib.grt_write_photon_csv(
        str(path).encode(), h, w, *(_ptr(a) for a in arrays),
        _ptr(cls32, ctypes.c_int32), *(_ptr(a) for a in rest))
    return rc == 0


def write_sampled_csv(path, xyz, heading) -> bool:
    """sampled_rays.csv through the native writer (xyz: (n_rays, n_pts,
    3)); False when it is not available or failed."""
    lib = load()
    if lib is None:
        return False
    xyz, heading = _f64(xyz), _f64(heading)
    rc = lib.grt_write_sampled_csv(str(path).encode(), xyz.shape[0],
                                   xyz.shape[1], _ptr(xyz), _ptr(heading))
    return rc == 0
