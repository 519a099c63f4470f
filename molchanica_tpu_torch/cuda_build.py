"""Build the port's CUDA kernel from csrc/colpair.cu at first use and load it.

The source exports a plain C entry point. It is compiled with nvcc for
sm_90a into a shared library under _build/, keyed by a hash of the source
and the flags, and loaded with ctypes. Nothing here includes PyTorch's
headers, so a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "colpair.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
# no --use_fast_math: the kernel's pair math must match the plain torch
# version (and the exclusion-subtraction path) to float32 roundoff
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
        raise RuntimeError("nvcc not found: the CUDA kernel builds only on "
                           "a machine with the CUDA toolkit")
    return path


def _target() -> str:
    with open(SOURCE, "rb") as fh:
        h = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"colpair_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/colpair.cu unless its library is current; its path."""
    global build_log
    out = _target()
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        build_log = proc.stdout
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/colpair.cu:\n"
                               f"{build_log}")
        os.replace(tmp, out)
    return out


def load_library():
    """The ctypes library of csrc/colpair.cu, built if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _P, _I = ctypes.c_void_p, ctypes.c_int
        lib.colpair_launch.argtypes = [_I] * 6 + [_P] * 9
        lib.colpair_launch.restype = ctypes.c_int
        _lib = lib
    return _lib
