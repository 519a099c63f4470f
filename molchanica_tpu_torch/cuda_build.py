"""Build the port's CUDA kernels from csrc/*.cu at first use and load them.

Each source exports a plain C entry point. Both sources are compiled with
one nvcc call for sm_90a into one shared library under _build/, keyed by a
hash of the sources and the flags, and loaded with ctypes. Nothing here
includes PyTorch's headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", name)
           for name in ("colpair.cu", "direct_force.cu")]
BUILD_DIR = os.path.join(_HERE, "_build")
# no --use_fast_math: the kernels' pair math must match the plain torch
# versions (and the exclusion-subtraction paths) to float32 roundoff
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""       # nvcc's output of the last build (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def _target() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless their library is current; its path."""
    global build_log
    out = _target()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/*.cu:\n{build_log}")
        os.replace(tmp, out)
    return out


def load_library():
    """The ctypes library of csrc/*.cu, built if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.colpair_launch.argtypes = [_I] * 8 + [_P] * 11
        lib.colpair_launch.restype = ctypes.c_int
        lib.direct_force_launch.argtypes = [_I] * 7 + [_F] + [_P] * 5
        lib.direct_force_launch.restype = ctypes.c_int
        _lib = lib
    return _lib
