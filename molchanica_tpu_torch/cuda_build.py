"""Build the port's CUDA kernels from csrc/*.cu at first use and load them.

Each source exports a plain C entry point. The sources are compiled for
sm_90a by one nvcc process each, all started together, and linked into one
shared library under _build/, keyed by a hash of the sources and the
flags, and loaded with ctypes. Nothing here includes PyTorch's headers, so
a build takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", name)
           for name in ("colpair.cu", "direct_force.cu", "probe_prefetch.cu",
                        "cluster_force.cu", "pme_stencil.cu")]
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math: the kernels' pair math must match the plain torch
# versions to float32 roundoff
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v"]

_P, _I, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_double
# argtypes of each source's C entry point (each returns a cudaError_t)
ENTRIES = {
    "colpair_launch": [_I] * 10 + [_P] * 13,
    "direct_force_launch": [_I] * 8 + [_F] + [_P] * 7 + [_I, _P],
    "probe_launch": [_I] * 3 + [_P] * 7,
    "cluster_force_launch": [_I] * 7 + [ctypes.c_longlong, _D] + [_P] * 5
    + [_I] + [_P] * 8,
    "pme_spread_launch": [_I] * 6 + [_P] * 6,
    "pme_gather_launch": [_I] * 6 + [_P] * 7,
}

_lib = None
build_log = ""       # nvcc's output of the last build (ptxas register report)
build_seconds = {}   # wall seconds of each nvcc process of the last build


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
    """Compile csrc/*.cu unless their library is current; its path. Each
    source's nvcc time (and the link's) goes to `build_seconds`."""
    global build_log
    out = _target()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out}.{os.getpid()}"
    objs = [f"{tag}.{os.path.basename(src)}.o" for src in SOURCES]

    def run(name, args):
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        build_seconds[name] = time.perf_counter() - t0
        return proc

    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            procs = list(pool.map(
                lambda so: run(os.path.basename(so[0]),
                               [*NVCC_FLAGS, "-c", "-o", so[1], so[0]]),
                zip(SOURCES, objs)))
        build_log = "".join(p.stdout for p in procs)
        bad = [os.path.basename(s) for s, p in zip(SOURCES, procs)
               if p.returncode != 0]
        if bad:
            raise RuntimeError(f"nvcc failed for {', '.join(bad)}:\n"
                               f"{build_log}")
        link = run("link", [*ARCH, "-shared", "-o", f"{tag}.tmp", *objs])
        build_log += link.stdout
        if link.returncode != 0:
            raise RuntimeError(f"nvcc could not link csrc/*.cu:\n"
                               f"{link.stdout}")
        os.replace(f"{tag}.tmp", out)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return out


def _bind(lib):
    """`lib` with the argtypes of each entry of ENTRIES that it exports."""
    for name, argtypes in ENTRIES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load_library():
    """The ctypes library of csrc/*.cu, built if needed."""
    global _lib
    if _lib is None:
        _lib = _bind(ctypes.CDLL(build()))
    return _lib


def build_variants(src_name, variants, out_dir):
    """{name: (ctypes library, ptxas report lines)}: csrc/`src_name` built
    into `out_dir` once per entry of `variants`, {name: [(old, new), ...]},
    with each text substitution applied (each `old` must match exactly
    once, so a variant fails loudly when the kernel changes); one nvcc
    process per variant, all started together. A variant's library stands
    in for `load_library()`'s, so the wrappers launch it."""
    with open(os.path.join(_HERE, "csrc", src_name)) as fh:
        src = fh.read()
    stem = os.path.splitext(src_name)[0]
    nvcc = _nvcc()
    procs = {}
    for name, subs in variants.items():
        text = src
        for a, b in subs:
            if text.count(a) != 1:
                raise RuntimeError(f"variant {name}: {a!r} does not match "
                                   f"exactly once in csrc/{src_name}")
            text = text.replace(a, b)
        cu = os.path.join(out_dir, f"{stem}_{name}.cu")
        so = os.path.join(out_dir, f"{stem}_{name}.so")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = (_bind(ctypes.CDLL(so)),
                      [line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line
                       or "Compiling entry" in line])
    return libs
