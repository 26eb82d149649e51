"""Build, load and launch the hand-written CUDA kernels
(``csrc/intersect.cu``: the searches; ``csrc/hair.cu``: the hair BSDF).

One nvcc call compiles every source into one shared library with a plain
C interface at first use, into ``yhair_tpu_torch/_build/`` (git-ignored),
named by a hash of the sources and flags so an edit to either rebuilds;
a later process finds the library and only loads it. The library is
loaded with ctypes. Nothing here runs at import: the CPU tests import
every module and have no nvcc. ``ENTRIES`` describes the C interface
once; every kernel call goes through ``launch``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SOURCES = (_PKG / "csrc" / "intersect.cu", _PKG / "csrc" / "hair.cu")
BUILD_DIR = _PKG / "_build"
# no fast math: FMA contraction off and IEEE division / square root keep
# the kernels bit-equal to the torch ops they replace (see the sources'
# notes)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-Xptxas", "-v"]

# argument kinds -> (C type, what ``launch`` takes): a device pointer (a
# tensor, or None for NULL), an int, a float; s the stream, appended
_KINDS = {"p": (ctypes.c_void_p, (torch.Tensor, type(None))),
          "i": (ctypes.c_int, int), "f": (ctypes.c_float, (int, float)),
          "s": (ctypes.c_void_p, ())}
# entry point -> (argument kinds in the order of its extern "C" parameter
# list, LAUNCHES key; None for a query)
ENTRIES = {
    "yhair_block_lists": ("pppppp" "iii" "pppp" "s", "lists_kernel"),
    "yhair_hit_pass": ("ppppppppp" "iiii" "ppppp" "s", "hit_kernel"),
    "yhair_any_pass": ("ppppppp" "iii" "ppp" "s", "any_kernel"),
    "yhair_tri_hit": ("ppppp" "ii" "ff" "pp" "s", "tri_hit_kernel"),
    "yhair_tri_any": ("pppppp" "ii" "f" "p" "s", "tri_any_kernel"),
    "yhair_tri_lanes": ("ii", None),
    "yhair_hair_shade": ("ppppp" "i" "p" "ii" "ppppp" "s", "hair_kernel"),
}
# CUDA kernel launches by kernel, added to by ``launch`` only
LAUNCHES = {key: 0 for _, key in ENTRIES.values() if key}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library of these sources + flags is: named by a hash of
    every source and the flags."""
    tag = hashlib.sha256(b"".join(f.read_bytes() for f in SOURCES)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libyhair_kernels_{tag}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels if these sources + flags were not built yet.
    -> (library path, nvcc's output: registers, shared memory, spills;
    "" where the library was there and nvcc did not run)."""
    lib = library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, SOURCES)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call, its signatures
    declared from ``ENTRIES``."""
    lib = ctypes.CDLL(str(build()[0]))
    for entry, (kinds, _) in ENTRIES.items():
        fn = getattr(lib, entry)
        fn.argtypes = [_KINDS[k][0] for k in kinds]
        fn.restype = ctypes.c_int
    return lib


def launch(entry, *args):
    """Launch C entry point ``entry`` on the current stream of the first
    tensor's device. args: all but the stream, in the C order; a tensor
    passes as its data pointer, None as NULL, ints and floats as they
    are. TypeError where they do not fit ``ENTRIES``, RuntimeError on a
    nonzero return (not counted); else one launch more in ``LAUNCHES``."""
    kinds, key = ENTRIES[entry]
    if len(args) + 1 != len(kinds) or key is None or not all(
            isinstance(x, _KINDS[k][1]) for k, x in zip(kinds, args)):
        raise TypeError(f"{entry} takes {kinds[:-1]!r} and the stream, "
                        f"not {[type(x).__name__ for x in args]}")
    dev = next(x.device for x in args if isinstance(x, torch.Tensor))
    err = getattr(library(), entry)(
        *(x.data_ptr() if isinstance(x, torch.Tensor) else x for x in args),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{key} launch failed: CUDA error {err}")
    LAUNCHES[key] += 1


def check(block, o, d, *expect):
    """Raise ValueError unless the rays o, d are float32 (N, 3) with N a
    multiple of ``block`` and the tensors of ``expect`` fit
    (``check_tensors``) on the rays' device: what the searches take."""
    n, f32 = o.shape[0], torch.float32
    if n % block:
        raise ValueError(f"rays must be (N, 3) with N % {block} == 0")
    check_tensors(o.device, (o, f32, (n, 3)), (d, f32, (n, 3)), *expect)


def check_tensors(device, *expect):
    """Raise ValueError unless each (tensor, dtype, shape) of ``expect``
    has that dtype and shape and is contiguous on ``device``; None
    tensors are skipped. A fourth item True lets the tensor's rows be
    strided (its last dimension still unit-strided): what the kernels
    take."""
    for x, dtype, shape, *strided_rows in expect:
        if x is None:
            continue
        if x.dtype != dtype or tuple(x.shape) != tuple(shape):
            raise ValueError(f"kernel inputs must be {dtype} {tuple(shape)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        dense = (x.stride(-1) == 1 if strided_rows and strided_rows[0]
                 else x.is_contiguous())
        if x.device != device or not dense:
            raise ValueError("kernel inputs must be contiguous on one device")
