"""Covalent bond inference from interatomic distances.

Copy of molchanica_tpu.molecules.bond_inference:
the same host code, so its results equal the reference's bit for bit.

Analog of the reference's `src/bond_inference.rs:36-43` (distance-based
covalent bonds via covalent radii with a spatial hash grid). H-bond detection
lives in analysis/hbonds.py.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .elements import COVALENT_RADII

_TOL = 0.45   # A beyond the sum of covalent radii


def infer_bonds(elements: Sequence[str], positions: np.ndarray,
                tol: float = _TOL) -> List[Tuple[int, int]]:
    """Pairs within (r_cov_i + r_cov_j + tol); grid-bucketed O(N)."""
    n = len(elements)
    pos = np.asarray(positions, float)
    radii = np.array([COVALENT_RADII.get(e.capitalize(), 0.8)
                      for e in elements])
    rmax = 2 * radii.max() + tol
    cell = max(rmax, 1.0)
    keys = np.floor(pos / cell).astype(np.int64)
    buckets: dict = {}
    for i, k in enumerate(map(tuple, keys)):
        buckets.setdefault(k, []).append(i)
    bonds = []
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    for k, idxs in buckets.items():
        neigh = []
        for o in offs:
            neigh.extend(buckets.get((k[0] + o[0], k[1] + o[1], k[2] + o[2]),
                                     []))
        for i in idxs:
            for j in neigh:
                if j <= i:
                    continue
                cut = radii[i] + radii[j] + tol
                d2 = ((pos[i] - pos[j]) ** 2).sum()
                if d2 < cut * cut and d2 > 0.16:   # >0.4 A guards overlaps
                    # hydrogens bond at most once (to the nearest heavy atom)
                    bonds.append((i, j))
    # prune multi-bonded hydrogens to their shortest partner
    h_best = {}
    keep = []
    for bi, (i, j) in enumerate(bonds):
        hi = elements[i].capitalize() == "H"
        hj = elements[j].capitalize() == "H"
        if hi or hj:
            h = i if hi else j
            d = ((pos[i] - pos[j]) ** 2).sum()
            if h not in h_best or d < h_best[h][0]:
                h_best[h] = (d, bi)
        else:
            keep.append(bi)
    keep.extend(bi for (_, bi) in h_best.values())
    return [bonds[bi] for bi in sorted(set(keep))]
