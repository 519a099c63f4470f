"""Hand-authored small test systems with GAFF2-style parameters (copy of
molchanica_tpu.systems.testmols).

Parameter values are typed in from the public GAFF2 literature (bond and
angle force constants, LJ rmin/eps). They let the engine be validated
(energy conservation, gradient consistency, per-term values) without any
parameter files. Positions come back as numpy arrays.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..topology import make_topology

_RMIN_TO_SIGMA = 2.0 / (2.0 ** (1.0 / 6.0))  # sigma = 2 * rmin_half / 2^(1/6)


def rmin_half_to_sigma(rmin_half: float) -> float:
    return rmin_half * _RMIN_TO_SIGMA


def build_ethanol(dtype=torch.float32, pad_atoms_to=None):
    """CH3-CH2-OH with GAFF2-style parameters. Returns (topology, x0[9,3]).

    Atom order: C1, H11, H12, H13, C2, H21, H22, O, HO
    """
    # LJ (rmin/2 in A, eps kcal/mol), GAFF2-style values
    lj = {
        "c3": (1.9069, 0.1078),
        "hc": (1.4593, 0.0208),
        "h1": (1.3593, 0.0208),
        "oh": (1.7213, 0.2104),
        "ho": (0.5370, 0.0047),
    }
    types = ["c3", "hc", "hc", "hc", "c3", "h1", "h1", "oh", "ho"]
    masses = [12.01, 1.008, 1.008, 1.008, 12.01, 1.008, 1.008, 16.00, 1.008]
    charges = [-0.0971, 0.0333, 0.0333, 0.0333, 0.1312, 0.0372, 0.0372,
               -0.6013, 0.3929]
    sig = [rmin_half_to_sigma(lj[t][0]) for t in types]
    eps = [lj[t][1] for t in types]

    C1, H11, H12, H13, C2, H21, H22, O, HO = range(9)
    bonds = [
        (C1, C2, 300.9, 1.5375),
        (C1, H11, 330.6, 1.0969), (C1, H12, 330.6, 1.0969),
        (C1, H13, 330.6, 1.0969),
        (C2, H21, 330.6, 1.0961), (C2, H22, 330.6, 1.0961),
        (C2, O, 316.7, 1.4233),
        (O, HO, 371.4, 0.9730),
    ]
    deg = math.pi / 180.0
    angles = [
        (C2, C1, H11, 46.8, 110.05 * deg), (C2, C1, H12, 46.8, 110.05 * deg),
        (C2, C1, H13, 46.8, 110.05 * deg),
        (H11, C1, H12, 39.4, 107.58 * deg), (H11, C1, H13, 39.4, 107.58 * deg),
        (H12, C1, H13, 39.4, 107.58 * deg),
        (C1, C2, H21, 46.8, 110.05 * deg), (C1, C2, H22, 46.8, 110.05 * deg),
        (C1, C2, O, 67.5, 110.19 * deg),
        (H21, C2, H22, 39.4, 107.58 * deg),
        (H21, C2, O, 50.9, 110.26 * deg), (H22, C2, O, 50.9, 110.26 * deg),
        (C2, O, HO, 48.0, 107.26 * deg),
    ]
    dihedrals = [
        # X-c3-c3-X 9 terms folded: k = 1.40/9 per path, n=3
        *[(h, C1, C2, x, 1.40 / 9.0, 3.0, 0.0)
          for h in (H11, H12, H13) for x in (H21, H22, O)],
        # X-c3-oh-X: k = 0.50/3, n=3
        *[(x, C2, O, HO, 0.50 / 3.0, 3.0, 0.0) for x in (C1, H21, H22)],
    ]

    top = make_topology(
        masses, charges, sig, eps,
        bonds=bonds, angles=angles, dihedrals=dihedrals,
        pad_atoms_to=pad_atoms_to, dtype=dtype,
    )

    # Rough starting geometry (gets minimized by callers before dynamics)
    x0 = np.array([
        [0.000, 0.000, 0.000],    # C1
        [-0.40, 1.020, 0.000],    # H11
        [-0.40, -0.51, 0.880],    # H12
        [-0.40, -0.51, -0.880],   # H13
        [1.535, 0.000, 0.000],    # C2
        [1.940, 0.510, 0.880],    # H21
        [1.940, 0.510, -0.880],   # H22
        [2.010, -1.345, 0.000],   # O
        [2.950, -1.400, 0.180],   # HO
    ])
    if pad_atoms_to:
        padded = np.zeros((pad_atoms_to, 3))
        padded[:9] = x0
        # spread padding atoms far away so they never interact numerically
        padded[9:] = 1e4 + 10.0 * np.arange(pad_atoms_to - 9)[:, None]
        x0 = padded
    return top, torch.tensor(x0, dtype=dtype).numpy()


def build_lj_dimer(sigma=3.4, eps=0.24, mass=39.95, r=4.0,
                   dtype=torch.float32):
    """Two neutral LJ particles (argon-like), the simplest NVE testbed."""
    top = make_topology(
        [mass, mass], [0.0, 0.0], [sigma, sigma], [eps, eps],
        dtype=dtype, pad_terms_to_multiple=8,
    )
    x0 = torch.tensor([[0.0, 0.0, 0.0], [r, 0.0, 0.0]], dtype=dtype)
    return top, x0.numpy()
