"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by its own `nvcc` into a shared library
with a plain C interface, which is loaded with `ctypes` (no PyTorch headers,
so a build takes seconds); the compilers for all sources are started
together.  A library lands in `build/grtrace_torch_kernels/` beside the
package, named by its source and a hash of the source and flags: it is built
at first use and reused while the source is unchanged.

Numerics: `-fmad=false`, no `--use_fast_math`, IEEE division and square
root (nvcc's defaults), so each kernel rounds exactly like its eager twin.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
import types
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "grtrace_torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# C entry points of each source; every integrator takes (state_in,
# state_out, ns_out, params, n, n_sub, steps, stream), a disk entry
# (`*_disk_*`) takes the recorder rows disk_out after ns_out, and a subring
# entry (`*_sub_*`) takes cnt_out and slot_out after ns_out and n_orders
# after steps; a trig entry (`*_trig_*`) takes (x, sin_out, cos_out,
# sincos_sin_out, sincos_cos_out, n, stream); a trajectory entry
# (`*_traj_*`) takes (q0, p0, traj_out, ns_out, params, n, n_sub, steps,
# stride, n_keep, stream); a trace entry (`*_trace_*`) takes (q0, p0, out,
# params, n, n_sub, steps, stream); a generic-engine integrator (`*_gen_*`,
# not a trajectory or trace entry) takes (q0, p0, out, ns_out, params, n,
# n_sub, steps, stream), and its disk entry (`*_gen_disk_*`, D1) (q0, p0,
# disk, out, ns_out, hit_out, params, n, n_sub, steps, stream); a tangent
# entry (`*_tangent_*` and `*_tangent2_*`, B6t with one and two directions)
# takes (state_in, tan_in, state_out, ns_out, disk_out, disk_d_out, params,
# dparams, n, n_sub, steps, stream)
ENTRIES = {
    "fantasy_eqc": ("grt_fantasy_eqc_launch", "grt_fantasy_eq_f64_launch",
                    "grt_fantasy_eqc_chunk_launch"),
    "fantasy_schw16": ("grt_fantasy_schw16_f32_launch",
                       "grt_fantasy_schw16_f64_launch",
                       "grt_fantasy_traj_f32_launch",
                       "grt_fantasy_traj_f64_launch",
                       "grt_fantasy_trace_f32_launch",
                       "grt_fantasy_trace_f64_launch",
                       "grt_fantasy_trig_f32_launch",
                       "grt_fantasy_trig_f64_launch"),
    "fantasy_ks": ("grt_fantasy_ks32_f32_launch",
                   "grt_fantasy_ks16_f32_launch",
                   "grt_fantasy_ks16_f64_launch",
                   "grt_fantasy_ks32_f32_disk_launch",
                   "grt_fantasy_ks16_f32_disk_launch",
                   "grt_fantasy_ks16_f64_disk_launch",
                   "grt_fantasy_ks32_f32_sub_launch",
                   "grt_fantasy_ks16_f32_sub_launch",
                   "grt_fantasy_ks16_f64_sub_launch",
                   "grt_fantasy_ks16_f32_disk_tangent_launch",
                   "grt_fantasy_ks16_f64_disk_tangent_launch",
                   "grt_fantasy_ks16_f32_disk_tangent2_launch",
                   "grt_fantasy_ks16_f64_disk_tangent2_launch"),
    "fantasy_gen": ("grt_fantasy_gen_bl_f32_launch",
                    "grt_fantasy_gen_bl_f64_launch",
                    "grt_fantasy_gen_traj_bl_f32_launch",
                    "grt_fantasy_gen_traj_bl_f64_launch",
                    "grt_fantasy_gen_traj_ks_f32_launch",
                    "grt_fantasy_gen_traj_ks_f64_launch",
                    "grt_fantasy_gen_trace_bl_f32_launch",
                    "grt_fantasy_gen_trace_bl_f64_launch",
                    "grt_fantasy_gen_static_f32_launch",
                    "grt_fantasy_gen_static_f64_launch",
                    "grt_fantasy_gen_traj_static_f32_launch",
                    "grt_fantasy_gen_traj_static_f64_launch",
                    "grt_fantasy_gen_trace_static_f32_launch",
                    "grt_fantasy_gen_trace_static_f64_launch",
                    "grt_fantasy_gen_disk_static_f32_launch",
                    "grt_fantasy_gen_disk_static_f64_launch",
                    "grt_fantasy_gen_rot_f32_launch",
                    "grt_fantasy_gen_rot_f64_launch",
                    "grt_fantasy_gen_traj_rot_f32_launch",
                    "grt_fantasy_gen_traj_rot_f64_launch",
                    "grt_fantasy_gen_trace_rot_f32_launch",
                    "grt_fantasy_gen_trace_rot_f64_launch",
                    "grt_fantasy_gen_disk_rot_f32_launch",
                    "grt_fantasy_gen_disk_rot_f64_launch",
                    "grt_fantasy_gen_kds_f32_launch",
                    "grt_fantasy_gen_kds_f64_launch",
                    "grt_fantasy_gen_traj_kds_f32_launch",
                    "grt_fantasy_gen_traj_kds_f64_launch",
                    "grt_fantasy_gen_trace_kds_f32_launch",
                    "grt_fantasy_gen_trace_kds_f64_launch",
                    "grt_fantasy_gen_disk_kds_f32_launch",
                    "grt_fantasy_gen_disk_kds_f64_launch"),
}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def argtypes(name: str) -> list:
    """The ctypes signature of the C entry `name`."""
    if "_trig_" in name:
        return [_PTR] * 5 + [_INT, _PTR]
    if "_disk_tangent" in name:
        return [_PTR] * 8 + [_INT] * 3 + [_PTR]
    if "_trace_" in name:
        return [_PTR] * 4 + [_INT] * 3 + [_PTR]
    if "_traj_" in name:
        return [_PTR] * 5 + [_INT] * 5 + [_PTR]
    if "_gen_disk_" in name:
        return [_PTR] * 7 + [_INT] * 3 + [_PTR]
    if "_gen_" in name:
        return [_PTR] * 5 + [_INT] * 3 + [_PTR]
    sub = "_sub_" in name
    recorders = 2 if sub else 1 if "_disk_" in name else 0
    return [_PTR] * (4 + recorders) + [_INT] * (4 if sub else 3) + [_PTR]


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


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


def library_path(source: Path) -> Path:
    """Where the library of `source`, at the current flags, lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(source.name.encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library is not built yet, with one nvcc
    per source, all started together.

    Returns {source stem: (library path, seconds until its nvcc finished,
    0.0 when the library already existed)}.  Each compiler's output (the
    ptxas register counts included) is kept in `<library>.log`.
    """
    libs = {src.stem: (src, library_path(src)) for src in _sources()}
    out = {stem: (lib, 0.0) for stem, (_, lib) in libs.items()}
    todo = {stem: pair for stem, pair in libs.items() if not pair[1].exists()}
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    running = {}
    for stem, (src, lib) in todo.items():
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[stem] = (proc, cmd, tmp, lib)
    failed = []
    for stem, (proc, cmd, tmp, lib) in running.items():
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        log = f"$ {' '.join(cmd)}\n{text}"
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {stem}.cu ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or none
        out[stem] = (lib, seconds)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def ptxas_summary(log: str) -> list:
    """[{kernel, registers, spill_stores, spill_loads}] from an nvcc -Xptxas
    -v log, one entry per compiled kernel (mangled names shortened to the
    kernel's name and template arguments)."""
    out = []
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"kernel": _short_name(m.group(1)), "registers": None,
                       "spill_stores": None, "spill_loads": None}
            out.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return out


def _short_name(mangled: str) -> str:
    """'..._18fantasy_ks_kernelIfLb1EEv...' -> 'fantasy_ks_kernel<f,1>'; an
    enum argument ('LNS_4ModeE2E') shows as its value."""
    m = re.search(r"\d+(fantasy_\w+?_kernel)(I(.*?)E)?E?v?P", mangled)
    if not m:
        return mangled
    args = m.group(3)
    if not args:
        return m.group(1)
    parts = re.findall(r"Lb(\d)|L\w*?E(\d+)E|([fd])", args)
    return f"{m.group(1)}<{','.join(''.join(p) for p in parts)}>"


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """Build if needed and load every kernel library; returns a namespace
    of the C entry points, their signatures declared."""
    built = build()
    fns = {}
    for stem, names in ENTRIES.items():
        lib = ctypes.CDLL(str(built[stem][0]))
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = argtypes(name)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)
