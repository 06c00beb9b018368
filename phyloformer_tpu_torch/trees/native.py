"""ctypes binding to the repository's native C++ tree toolkit (``native/``):
the BME/NJ/BIONJ tree builder with balanced NNI and SPR, and the tree
metrics (RF, normalised and weighted RF, KF; the balanced tree length).

The shared library is built on first use from ``native/src`` into this
package's ``trees/build/`` (listed in ``.gitignore``), named by a hash of the
sources, with the ``g++`` found on ``PATH``.  ``$CXX`` is not read: where it
names another toolchain or a compiler wrapper, the library it builds can
crash on its first call next to the interpreter's own C++ runtime.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..data.phylip import matrix_to_phylip

_SRC_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native" / "src"
_SOURCES = ("pftree.cc", "capi.cc")
_HEADERS = ("pftree.h",)
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libpftree_{h.hexdigest()[:16]}.so"


def build_native() -> pathlib.Path:
    """Compile the library unless one of the current sources exists, under
    an exclusive file lock so concurrent first users cannot race."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise NativeUnavailable("could not build the native toolkit: no g++ on PATH")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *_CXX_FLAGS, "-o", str(tmp)] + [str(_SRC_DIR / s) for s in _SOURCES]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise NativeUnavailable(f"could not build the native toolkit:\n{' '.join(cmd)}\n"
                                    f"{res.stderr}")
        os.replace(tmp, out)
    return out


def get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_native()))
        lib.pftree_build.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.pftree_build.restype = ctypes.c_int
        lib.pftree_compare.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.pftree_compare.restype = ctypes.c_int
        lib.pftree_pauplin_length.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.pftree_pauplin_length.restype = ctypes.c_double
        _lib = lib
    return _lib


def build_tree_from_phylip(
    phylip_text: str, method: str = "bme", nni: bool = True, spr: bool = True
) -> str:
    """Distance matrix (PHYLIP text) -> newick tree string."""
    lib = get_lib()
    buf = ctypes.create_string_buffer(1 << 20)
    rc = lib.pftree_build(
        phylip_text.encode(), method.encode(), int(nni), int(spr), buf, len(buf)
    )
    if rc != 0:
        raise RuntimeError(f"pftree_build failed ({rc}): {buf.value.decode(errors='replace')}")
    return buf.value.decode()


def build_tree(
    matrix: np.ndarray,
    ids: Sequence[str],
    method: str = "bme",
    nni: bool = True,
    spr: bool = True,
) -> str:
    return build_tree_from_phylip(matrix_to_phylip(matrix, ids), method, nni, spr)


@dataclass
class TreeComparison:
    rf: float
    norm_rf: float
    weighted_rf: float
    kf: float  # phylocompare's kf_score convention (internal bipartitions)
    n_common: int


def compare_newick(
    nwk_a: str, nwk_b: str, include_external: bool = False
) -> TreeComparison:
    lib = get_lib()
    out = (ctypes.c_double * 5)()
    rc = lib.pftree_compare(nwk_a.encode(), nwk_b.encode(), int(include_external), out)
    if rc != 0:
        raise RuntimeError("pftree_compare failed (leaf sets differ or parse error)")
    return TreeComparison(
        rf=out[0], norm_rf=out[1], weighted_rf=out[2], kf=out[3], n_common=int(out[4])
    )


def pauplin_length(phylip_text: str, nwk: str) -> float:
    """Balanced (Pauplin) length of the topology ``nwk`` under the PHYLIP
    matrix ``phylip_text``; -1.0 where either does not parse."""
    lib = get_lib()
    return float(lib.pftree_pauplin_length(phylip_text.encode(), nwk.encode()))
