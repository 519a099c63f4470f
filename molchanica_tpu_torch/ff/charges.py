"""Partial-charge assignment: Gasteiger-Marsili PEOE.

Copy of molchanica_tpu.ff.charges:
the same host code, so its results equal the reference's bit for bit.

Reference surface: `partial_charge_inference::infer_charge` (an AM1-BCC-style
NN in the reference, SURVEY.md §2.1). Here: the classic Gasteiger iterative
partial-equalization scheme — deterministic, dependency-free, adequate
starting charges; exact charges can always be supplied via mol2/SDF input or
a trained model (models/charges, later round).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# Gasteiger a, b, c electronegativity parameters per (element, hybridization)
# from the original 1980 paper (public data).
_PARAMS = {
    ("H", 1): (7.17, 6.24, -0.56),
    ("C", 4): (7.98, 9.18, 1.88),     # sp3
    ("C", 3): (8.79, 9.32, 1.51),     # sp2
    ("C", 2): (10.39, 9.45, 0.73),    # sp
    ("N", 4): (11.54, 10.82, 1.36),   # sp3 (incl. ammonium)
    ("N", 3): (12.87, 11.15, 0.85),   # sp2
    ("N", 2): (15.68, 11.70, -0.27),  # sp
    ("O", 4): (14.18, 12.92, 1.39),   # sp3
    ("O", 3): (17.07, 13.79, 0.47),   # sp2 (carbonyl)
    ("S", 4): (10.14, 9.13, 1.38),
    ("P", 4): (8.90, 8.24, 0.96),
    ("F", 4): (14.66, 13.85, 2.31),
    ("Cl", 4): (11.00, 9.69, 1.35),
    ("Br", 4): (10.08, 8.47, 1.16),
    ("I", 4): (9.90, 7.96, 0.96),
}


def gasteiger_charges(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    bond_orders: Sequence[float] = None,
    formal_charges: Sequence[int] = None,
    n_iters: int = 8,
) -> np.ndarray:
    """Iterative partial equalization of orbital electronegativity."""
    n = len(elements)
    adj = [[] for _ in range(n)]
    omax = {}
    for bi, (i, j) in enumerate(bonds):
        adj[i].append(j)
        adj[j].append(i)
        o = 1.0 if bond_orders is None else float(bond_orders[bi])
        omax[i] = max(omax.get(i, 1.0), o)
        omax[j] = max(omax.get(j, 1.0), o)

    abc = np.zeros((n, 3))
    for i, e in enumerate(elements):
        e = e.capitalize()
        if e == "H":
            hyb = 1
        else:
            o = omax.get(i, 1.0)
            hyb = 4 if o < 1.25 else (3 if o < 2.5 else 2)
        p = _PARAMS.get((e, hyb)) or _PARAMS.get((e, 4)) \
            or _PARAMS[("C", 4)]
        abc[i] = p

    q = np.zeros(n)
    if formal_charges is not None:
        q += np.asarray(formal_charges, float)
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    # cation electronegativity: chi at q=+1
    chi_plus = a + b + c
    chi_plus = np.where(np.array([e.capitalize() == "H"
                                  for e in elements]), 20.02, chi_plus)
    damp = 1.0
    for it in range(n_iters):
        damp *= 0.5
        chi = a + b * q + c * q * q
        dq = np.zeros(n)
        for i in range(n):
            for j in adj[i]:
                if chi[j] > chi[i]:
                    denom = chi_plus[i]
                else:
                    denom = chi_plus[j]
                dq[i] += (chi[j] - chi[i]) / max(denom, 1e-6) * damp
        q += dq
    return q
