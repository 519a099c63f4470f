"""Electronegativity-equalization (QEq/EEM) partial charges.

Copy of molchanica_tpu.ff.charges_eem:
the same host code, so its results equal the reference's bit for bit.

A geometry-aware charge model to complement the topology-only Gasteiger
PEOE in ff/charges.py: minimize

    E(q) = sum_i (chi_i q_i + 1/2 J_i q_i^2) + sum_{i<j} k q_i q_j / r_ij

subject to sum q_i = Q_total, which is one (n+1)x(n+1) linear solve. chi
(electronegativity) and J (idempotential / hardness) are the published
Rappe & Goddard QEq atomic parameters (J. Phys. Chem. 95, 3358 (1991),
Table 1). The off-diagonal Coulomb uses the standard EEM 1/r form with a
short-range cap at the two-center hardness (the Nishimoto-Mataga-style
interpolation QEq uses; caps keep bonded neighbors finite).

This is the framework's stand-in for the reference's AM1-BCC-style neural
charge inference (`dynamics::partial_charge_inference`, SURVEY §2.1 —
trained on ~30k GeoStd molecules, not reproducible offline): a real
published physical model rather than a fit, typically closer to QM ESP
charges than Gasteiger on polar molecules.
"""
from __future__ import annotations

from typing import List

import numpy as np

# Rappe-Goddard QEq parameters: element -> (chi [eV], J [eV])
QEQ_PARAMS = {
    "H": (4.528, 13.890),
    "Li": (3.006, 4.772),
    "C": (5.343, 10.126),
    "N": (6.899, 11.760),
    "O": (8.741, 13.364),
    "F": (10.874, 14.948),
    "Na": (2.843, 4.592),
    "Si": (4.168, 6.974),
    "P": (5.463, 8.000),
    "S": (6.928, 8.972),
    "Cl": (8.564, 9.892),
    "K": (2.421, 3.840),
    "Br": (7.790, 8.850),
    "I": (6.822, 7.524),
}

_EV_ANG = 14.39964            # e^2/(4 pi eps0) in eV*Angstrom


def eem_charges(elements: List[str], positions, total_charge: float = 0.0
                ) -> np.ndarray:
    """Solve the equalization system; returns charges [n] summing to
    total_charge."""
    n = len(elements)
    if n == 0:
        return np.zeros(0)
    chi = np.empty(n)
    J = np.empty(n)
    for i, e in enumerate(elements):
        c, j = QEQ_PARAMS.get(e, QEQ_PARAMS["C"])
        chi[i] = c
        J[i] = j
    x = np.asarray(positions, np.float64).reshape(n, 3)
    if n == 1:
        return np.asarray([total_charge], np.float64)
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    # Louwen-Vogt shielded Coulomb: k/sqrt(r^2 + (2k/(J_i+J_j))^2) — the
    # smooth interpolation standard EEM codes use; it tends to the
    # two-center hardness (J_i+J_j)/2 as r -> 0 (a hard cap makes the
    # matrix singular for tightly bonded pairs) and to k/r at long range.
    shield = 2.0 * _EV_ANG / (J[:, None] + J[None, :])
    off = _EV_ANG / np.sqrt(d * d + shield * shield)
    A = off.copy()
    np.fill_diagonal(A, J)
    # KKT system: [A 1; 1^T 0] [q; lam] = [-chi; Q]
    M = np.zeros((n + 1, n + 1))
    M[:n, :n] = A
    M[:n, n] = 1.0
    M[n, :n] = 1.0
    rhs = np.concatenate([-chi, [float(total_charge)]])
    sol = np.linalg.solve(M, rhs)
    return sol[:n]


def assign_eem_charges(mol, total_charge: float = 0.0) -> np.ndarray:
    """Charges for a MoleculeCommon; does not mutate the molecule."""
    return eem_charges(mol.elements, mol.positions, total_charge)
