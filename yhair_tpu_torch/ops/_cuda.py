"""Build and load the hand-written CUDA kernels (``csrc/intersect.cu``).

nvcc compiles the source into a shared library with a plain C interface
at first use, into ``yhair_tpu_torch/_build/`` (git-ignored), named by a
hash of the source and flags so an edit rebuilds. The library is loaded
with ctypes. Nothing here runs at import: the CPU tests import every
module and have no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "intersect.cu"
BUILD_DIR = _PKG / "_build"
# no fast math: FMA contraction off and IEEE division / square root keep
# the kernels' t bit-equal to the torch recompute (see the source's note)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v"]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> tuple[Path, str]:
    """Compile the kernels if this source + flags were not built yet.
    -> (library path, nvcc's output: registers, shared memory, spills)."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libyhair_intersect_{tag}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.yhair_hit_pass.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p,
                                   p, p, p, p, p]
    lib.yhair_hit_pass.restype = i
    lib.yhair_any_pass.argtypes = [p, p, p, p, p, p, p, i, i, i, p, p, p, p]
    lib.yhair_any_pass.restype = i
    lib.yhair_block_lists.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p, p,
                                      p]
    lib.yhair_block_lists.restype = i
    f = ctypes.c_float
    lib.yhair_tri_hit.argtypes = [p, p, p, p, p, i, i, f, f, p, p, p]
    lib.yhair_tri_hit.restype = i
    lib.yhair_tri_any.argtypes = [p, p, p, p, p, p, i, i, f, p, p]
    lib.yhair_tri_any.restype = i
    lib.yhair_tri_lanes.argtypes = [i, i]
    lib.yhair_tri_lanes.restype = i
    return lib
