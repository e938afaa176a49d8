"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Every ``csrc/*.cu`` file exports plain C entry points (no PyTorch headers),
so one ``nvcc`` call builds them all into one shared library in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/cuda/libsdpcutsel_kernels_<hash>.so csrc/*.cu

The library lands in ``<repo>/build/cuda/`` (listed in ``.gitignore``) under
a name keyed by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  Pointers and the stream pass as
``c_void_p``; every entry point returns ``cudaGetLastError()`` and
``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cuda")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every C entry point in csrc/
_SIGNATURES = {
    # pair_score.cu
    "pair_score_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P],
    # pdhg_block.cu
    "pdhg_block_launch": [_I, _I, _I, _I, _F, _F,
                          _P, _P,
                          _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P,
                          _P, _P, _P, _P, _P,
                          _P, _P,
                          _P],
}

_lib = None
build_log = ""          # nvcc's output of the last build (registers, spills)
build_seconds = 0.0     # wall time of the last nvcc run in this process


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libsdpcutsel_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the build directory unless already built."""
    global build_log, build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()],
                          capture_output=True, text=True, timeout=600)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
