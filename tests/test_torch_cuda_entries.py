"""The ctypes argtypes of every C entry point in csrc/*.cu
(molchanica_tpu_torch/cuda_build.py's ENTRIES) follow the entry's C
parameter list, type by type: an int where a pointer is declared, or a
missing argument, would pass the wrong bits without an error. Reads the
sources only; runs without a card."""
import ctypes
import re

import pytest

from molchanica_tpu_torch import cuda_build

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "double": ctypes.c_double, "long long": ctypes.c_longlong}


def _c_params(name):
    """The ctypes type of each parameter of `extern "C" int name(...)` in
    the sources."""
    for path in cuda_build.SOURCES:
        with open(path) as fh:
            src = fh.read()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        if m:
            break
    else:
        raise AssertionError(f"{name} is in no source")
    types = []
    for p in m.group(1).split(","):
        decl = re.sub(r"\bconst\b", "", p).strip()
        if "*" in decl:
            types.append(ctypes.c_void_p)
        else:
            types.append(C_TYPES[" ".join(decl.split()[:-1])])
    return types


@pytest.mark.parametrize("name", sorted(cuda_build.ENTRIES))
def test_argtypes_follow_the_c_signature(name):
    assert cuda_build.ENTRIES[name] == _c_params(name)


def test_pme_stencil_entries():
    """SPME's spread and gather (csrc/pme_stencil.cu) are built and bound:
    dtype, replicas, sites and the three mesh sides, then the pointers
    (x, q, box; the spread's integer scratch and mesh, the gather's phi,
    gx, gq) and the stream."""
    assert "pme_stencil.cu" in [p.split("/")[-1] for p in cuda_build.SOURCES]
    P, I = ctypes.c_void_p, ctypes.c_int
    assert cuda_build.ENTRIES["pme_spread_launch"] == [I] * 6 + [P] * 6
    assert cuda_build.ENTRIES["pme_gather_launch"] == [I] * 6 + [P] * 7
