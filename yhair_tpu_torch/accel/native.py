"""ctypes loader of the native C++ cluster builder
(``native/cluster_builder.cpp``; ``yhair_tpu/accel/native.py``).

At first use g++ compiles the repository's source, with the flags of
``native/build.sh``, into ``yhair_tpu_torch/_build/`` (git-ignored),
named by a hash of the source, the flags and the host's name, so an
edited source is rebuilt, and so is a library that ``-march=native``
built for another machine's CPU.
``native/lib/`` is the JAX package's and is neither read nor written.
Where no g++ (or no source) exists, ``available()`` is False and
``build_clusters`` returns None: the caller then takes the numpy build
(``accel/lbvh.py``). A compiler that is there but fails raises. This is
a host-side scene build, not a device kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "cluster_builder.cpp"
BUILD_DIR = _PKG / "_build"
# native/build.sh's flags
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def build() -> Path | None:
    """Compile the builder unless this source, flags and host have a
    library.
    -> the library's path, or None without g++ or without the source."""
    cxx = shutil.which("g++")
    if cxx is None or not SOURCE.is_file():
        return None
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()
                         + platform.node().encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libyhair_native_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _lib():
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.yh_n_clusters.restype = ctypes.c_int64
    lib.yh_n_clusters.argtypes = [ctypes.c_int64, ctypes.c_int64]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for fn in (lib.yh_build_clusters, lib.yh_build_clusters_median):
        fn.restype = ctypes.c_int
        fn.argtypes = [f32p, f32p, f32p, f32p, ctypes.c_int64,
                       ctypes.c_int64, f32p, f32p, f32p, f32p, i32p]
    return lib


def available() -> bool:
    """Whether the library is built (or can be): False only without g++
    or without ``native/cluster_builder.cpp``."""
    return _lib() is not None


def build_clusters(p0, p1, r0, r1, cluster_size=128, method="median"):
    """Native cluster build -> dict of ``s0``, ``s1`` ((C*k, 4) f32),
    ``cmin``, ``cmax`` ((C, 3), 4e30 for empty clusters), ``seg_index``
    ((C*k,) int32, -1 = padding), ``n_clusters``, ``cluster_size``; or
    None when the library is unavailable. method: "median" or
    "morton"."""
    lib = _lib()
    if lib is None:
        return None
    fn = {"median": lib.yh_build_clusters_median,
          "morton": lib.yh_build_clusters}.get(method)
    if fn is None:
        raise ValueError(f"unknown method {method!r}")
    p0 = np.ascontiguousarray(p0, np.float32).reshape(-1, 3)
    p1 = np.ascontiguousarray(p1, np.float32).reshape(-1, 3)
    r0 = np.ascontiguousarray(r0, np.float32).reshape(-1)
    r1 = np.ascontiguousarray(r1, np.float32).reshape(-1)
    n = p0.shape[0]
    if not (p1.shape[0] == r0.shape[0] == r1.shape[0] == n):
        raise ValueError("p0, p1, r0 and r1 must describe the same "
                         "segments")
    c = int(lib.yh_n_clusters(n, cluster_size))
    padded = c * cluster_size
    s0 = np.empty((padded, 4), np.float32)
    s1 = np.empty((padded, 4), np.float32)
    cmin = np.empty((c, 3), np.float32)
    cmax = np.empty((c, 3), np.float32)
    seg_index = np.empty(padded, np.int32)
    rc = fn(p0, p1, r0, r1, n, cluster_size, s0, s1, cmin, cmax, seg_index)
    if rc != 0:
        raise RuntimeError(f"native cluster build ({method}) failed: {rc}")
    return {"s0": s0, "s1": s1, "cmin": cmin, "cmax": cmax,
            "seg_index": seg_index, "n_clusters": c,
            "cluster_size": cluster_size}
