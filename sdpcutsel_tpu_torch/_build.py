"""Build the CUDA kernels in ``csrc/`` at first use and bind them with ctypes.

Every ``csrc/*.cu`` file exports plain C entry points (no PyTorch headers).
One ``nvcc`` per source compiles them all at once, in parallel, and one more
links the objects into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <hash>/<name>.o csrc/<name>.cu   # each
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/cuda/libsdpcutsel_kernels_<hash>.so <hash>/*.o

The library lands in ``<repo>/build/cuda/`` (listed in ``.gitignore``) under
a name keyed by a hash of the sources (``*.cu`` and the ``*.cuh`` they
include) and flags, so an edited source is rebuilt and an unchanged one is
reused.  Pointers and the stream pass as
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argtypes of every C entry point in csrc/
_SIGNATURES = {
    # fused_score.cu
    "fused_score_grid": [_I, _P],
    "fused_score_launch": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P],
    # pair_packed.cu
    "pair_packed_grid": [_P],
    "pair_packed_launch": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],
    # pair_score.cu
    "pair_score_grid": [_P],
    "pair_score_launch": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P],
    # pdhg_block.cu
    "pdhg_block_launch": [_I, _I, _I, _I, _I, _I, _I, _I,  # n M k m iters cluster cap smem
                          _I, _P, _P, _P, _I, _I,      # count, ids, tau, sigma, ex, eX
                          _P, _P,                      # cx, cX
                          _P, _P, _P, _P, _P,          # idx, lin, quad, rhs, act
                          _P, _P, _P, _P, _P, _P,      # xoff xcut xcoef Xoff Xcut Xcoef
                          _P, _P, _P,                  # G, g, h
                          *[_P] * 12,                  # state and sums in
                          *[_P] * 12,                  # state and sums out
                          _P],                         # stream
    "pdhg_block_max_active_clusters": [_I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_log = ""          # nvcc's output of the last build (registers, spills)
build_seconds = 0.0     # wall time of the last build (compiles + link) in this process


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
    tmp = f"{out}.{os.getpid()}.tmp"
    obj_dir = f"{tmp}.d"
    os.makedirs(obj_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        objs.append(os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o"))
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], src],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs, failed = [], []
    try:
        for src, proc in zip(sources(), procs):
            logs.append(proc.communicate(timeout=600)[0])
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode})")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True, timeout=600)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
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
