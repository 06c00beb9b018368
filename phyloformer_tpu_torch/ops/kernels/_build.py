"""Build and load the CUDA kernels of ``csrc/`` on first use.

``nvcc`` compiles each source of this package into an object, all sources
at once in parallel, and links the objects into one shared library with a
plain C interface, which :func:`load` opens with ``ctypes``.  The library
lands in ``ops/kernels/build/`` (listed in ``.gitignore``), named by a hash
of the sources, so an edited source is rebuilt and an unchanged one is not.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

from ...spans import setup_span

_HERE = pathlib.Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
SOURCES = ("axial_pipeline.cu", "axial_pipeline_m.cu", "axial_pipeline_m_bf16.cu",
           "axial_fused.cu", "axial_bwd.cu", "axial_bwd_tc.cu", "slot_reduce.cu")
HEADERS = ("axial_pipeline.cuh", "axial_bodies.cuh", "axial_bwd.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
# Wall-clock seconds of the last nvcc run in this process (0.0 when the
# library was already built), and the compiler's resource report.
build_seconds = 0.0
ptxas_log = ""

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pf_weight_sizes": [_p],
    # the forward's entries end in their variant codes: passes, then storage
    # (P0, A-only), or gelu, passes, storage (Z), or gelu, passes (M at fp32
    # storage, on warpgroup MMA, and at bf16)
    "pf_kernel_p0": [_p] * 12 + [_i] * 5 + [_f, _i, _i, _p],
    "pf_kernel_a_only": [_p] * 9 + [_i] * 4 + [_f, _i, _i, _p],
    "pf_kernel_a": [_p] * 10 + [_i] * 4 + [_f, _i, _p],
    "pf_kernel_m": [_p] * 13 + [_i] * 4 + [_f, _i, _i, _p],
    "pf_kernel_m_bf16": [_p] * 13 + [_i] * 4 + [_f, _i, _i, _p],
    "pf_kernel_z": [_p] * 8 + [_i] * 4 + [_f, _i, _i, _i, _p],
    "pf_kernel_a1": [_p] * 5 + [_i] * 4 + [_f, _i, _p],
    "pf_kernel_a2": [_p] * 10 + [_i] * 5 + [_f, _i, _p],
    "pf_kernel_b": [_p] * 6 + [_i] * 4 + [_f, _i, _p],
    "pf_bwd_sizes": [_p],
    "pf_bwd_tc_sizes": [_p],
    # the backward's tensor-core entries end in their TF32 passes
    "pf_kernel_c": [_p] * 10 + [_i] * 4 + [_f, _i, _p],
    "pf_kernel_d": [_p] * 10 + [_i] * 4 + [_f, _i, _p],
    "pf_kernel_e": [_p] * 7 + [_i] * 4 + [_f, _i, _p],
    "pf_kernel_e1": [_p] * 6 + [_i] * 6 + [_f, _p],
    "pf_kernel_e2": [_p] * 8 + [_i] * 5 + [_f, _i, _p],
    "pf_reduce_slots": [_p] * 2 + [_i] * 5 + [_p],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine "
                       "with the card (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS + (" ".join(NVCC_FLAGS),):
        path = SRC_DIR / name
        h.update(path.read_bytes() if path.exists() else name.encode())
    return BUILD_DIR / f"libpf_axial_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless a library of the current sources exists."""
    global build_seconds, ptxas_log
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        objs = [out.with_name(f"{out.stem}.{os.getpid()}.{s}.o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(SRC_DIR / s)]
                for s, o in zip(SOURCES, objs)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        ptxas_log = "".join(f"== {s}\n{log}" for s, log in zip(SOURCES, logs))
        failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            link = [nvcc, "-shared", "-o", str(tmp)] + [str(o) for o in objs]
            res = subprocess.run(link, capture_output=True, text=True)
            ptxas_log += res.stdout + res.stderr
            if res.returncode != 0:
                failed.append((link, res.returncode))
        build_seconds = time.perf_counter() - t0
        for o in objs:
            o.unlink(missing_ok=True)
        if failed:
            cmd, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{ptxas_log}")
        (BUILD_DIR / (out.stem + ".ptxas.txt")).write_text(ptxas_log)
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, open the library and declare its C signatures."""
    global _lib
    if _lib is None:
        with setup_span("setup.library"):
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pf_error_string.argtypes = [ctypes.c_int]
            lib.pf_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if rc != 0:
        msg = lib.pf_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
