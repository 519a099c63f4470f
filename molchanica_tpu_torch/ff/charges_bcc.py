"""Bond-charge-correction (BCC) partial charges: AM1-BCC-style formalism.

Copy of molchanica_tpu.ff.charges_bcc:
the same host code, so its results equal the reference's bit for bit.

Reference surface: `dynamics::partial_charge_inference::infer_charge` — the
reference ships a neural model trained on ~30k GeoStd molecules
(papers/tdc_inference.typst:74), which is not reproducible
offline. This module implements the published AM1-BCC *formalism*
(Jakalian, Bush, Jack & Bayly, J. Comput. Chem. 21:132 (2000) and 23:1623
(2002)): a cheap base charge model plus antisymmetric per-bond corrections

    q_i = q_i^base + sum_{bonds (i,j)} T[type_i, type_j]

where T is looked up by the (ordered) BCC atom-type pair and applied with
opposite signs to the two ends, so the molecular net charge is conserved
exactly by construction.

Parameterization (honest, offline): the original BCC table corrects AM1
Mulliken populations toward HF/6-31G* ESP charges. No AM1 implementation
exists here, so the correction table is FIT IN-REPO on top of Gasteiger
PEOE base charges against the published Amber ff14SB residue charge set
already embedded in ff/data/protein_ff14sb.py (scripts/fit_bcc.py solves
the ridge least-squares over all residue templates and writes
ff/data/bcc_table.py). The fit quality vs the Amber charges is pinned in
tests/test_charges_bcc.py — RMS error roughly halves vs plain Gasteiger.

BCC atom types follow the 2002 paper's taxonomy (tetravalent C, aromatic C,
carbonyl C, amide N, hydroxyl O, carbonyl O, ... — see `bcc_atom_types`),
derived purely from the bonded graph + bond orders, so typing works for
arbitrary small molecules, not just residues.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .charges import gasteiger_charges

# ---------------------------------------------------------------------------
# BCC atom types (numeric codes in the spirit of Jakalian 2002 Table I).
# ---------------------------------------------------------------------------
C_SP3 = 11          # tetravalent carbon
C_AR = 12           # aromatic carbon
C_SP2 = 13          # non-aromatic sp2 carbon (C=C)
C_SP = 14           # sp carbon
C_CARBONYL = 15     # carbonyl / carboxyl / amide carbon (C=O)
N_SP3 = 21          # amine nitrogen
N_AR = 22           # aromatic nitrogen
N_AMIDE = 23        # amide / conjugated planar nitrogen
N_SP2 = 24          # imine / sp2 nitrogen (C=N)
N_SP = 25           # nitrile nitrogen
N_CHARGED = 26      # ammonium / guanidinium nitrogen (4 bonds or formal +)
O_SP3 = 31          # hydroxyl / ether oxygen
O_CARBONYL = 32     # carbonyl oxygen (C=O)
O_CARBOXYLATE = 33  # carboxylate / phosphate anionic oxygen
S_ANY = 41
P_ANY = 51
F_ = 61
CL = 62
BR = 63
I_ = 64
H_C = 91            # H on carbon
H_N = 92            # H on nitrogen
H_O = 93            # H on oxygen
H_S = 94            # H on sulfur

_HAL = {"F": F_, "Cl": CL, "Br": BR, "I": I_}


def bcc_atom_types(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    bond_orders: Optional[Sequence[float]] = None,
    formal_charges: Optional[Sequence[int]] = None,
) -> List[int]:
    """Assign BCC atom types from the bonded graph.

    bond_orders: 1 / 2 / 3, aromatic = 1.5. Defaults to all single."""
    n = len(elements)
    bo = ([1.0] * len(bonds) if bond_orders is None
          else [float(b) for b in bond_orders])
    fc = ([0] * n if formal_charges is None
          else [int(c) for c in formal_charges])
    adj: List[List[Tuple[int, float]]] = [[] for _ in range(n)]
    for (i, j), o in zip(bonds, bo):
        adj[i].append((j, o))
        adj[j].append((i, o))

    def has_double_to(i, elem):
        return any(abs(o - 2.0) < 0.25 and elements[j] == elem
                   for j, o in adj[i])

    types = []
    for i, el in enumerate(elements):
        nb = adj[i]
        deg = len(nb)
        omax = max((o for _, o in nb), default=1.0)
        aromatic = any(abs(o - 1.5) < 0.25 for _, o in nb)
        if el == "C":
            if has_double_to(i, "O") or has_double_to(i, "S"):
                t = C_CARBONYL
            elif omax >= 2.75 or (deg == 2 and omax >= 1.75):
                t = C_SP
            elif aromatic:
                t = C_AR
            elif omax >= 1.75:
                t = C_SP2
            else:
                t = C_SP3
        elif el == "N":
            if deg >= 4 or fc[i] > 0:
                t = N_CHARGED
            elif omax >= 2.75:
                t = N_SP
            elif aromatic:
                t = N_AR
            elif any(elements[j] == "C" and has_double_to(j, "O")
                     for j, _ in nb):
                t = N_AMIDE
            elif omax >= 1.75:
                t = N_SP2
            else:
                t = N_SP3
        elif el == "O":
            if fc[i] < 0 or (deg == 1 and any(
                    elements[j] == "C"
                    and sum(1 for k, _ in adj[j]
                            if elements[k] == "O"
                            and len(adj[k]) == 1) >= 2
                    for j, _ in nb)):
                t = O_CARBOXYLATE
            elif omax >= 1.75:
                t = O_CARBONYL
            else:
                t = O_SP3
        elif el == "H":
            parent = elements[nb[0][0]] if nb else "C"
            t = {"N": H_N, "O": H_O, "S": H_S}.get(parent, H_C)
        elif el == "S":
            t = S_ANY
        elif el == "P":
            t = P_ANY
        elif el in _HAL:
            t = _HAL[el]
        else:
            t = C_SP3        # benign fallback: shares corrections with C
        types.append(t)
    return types


def _load_table() -> dict:
    try:
        from .data.bcc_table import BCC_TABLE
        return dict(BCC_TABLE)
    except ImportError:          # table not fit yet
        return {}


def apply_bcc(
    base_charges: Sequence[float],
    types: Sequence[int],
    bonds: Sequence[Tuple[int, int]],
    table: Optional[dict] = None,
) -> np.ndarray:
    """q_i += T[(t_i, t_j)] per bond, antisymmetric: the correction is
    stored for the ORDERED pair (min, max) and added to the lower-typed
    end, subtracted from the higher-typed end (same-type bonds are a
    no-op by symmetry). Net molecular charge is exactly conserved."""
    t = _load_table() if table is None else table
    q = np.asarray(base_charges, np.float64).copy()
    for i, j in bonds:
        ti, tj = types[i], types[j]
        if ti == tj:
            continue
        a, b = (i, j) if ti < tj else (j, i)
        corr = t.get((min(ti, tj), max(ti, tj)))
        if corr is not None:
            q[a] += corr
            q[b] -= corr
    return q


def bcc_charges(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    bond_orders: Optional[Sequence[float]] = None,
    formal_charges: Optional[Sequence[int]] = None,
    n_iters: int = 8,
) -> np.ndarray:
    """Gasteiger PEOE base + fitted bond charge corrections."""
    base = gasteiger_charges(elements, bonds, bond_orders=bond_orders,
                             formal_charges=formal_charges, n_iters=n_iters)
    types = bcc_atom_types(elements, bonds, bond_orders=bond_orders,
                           formal_charges=formal_charges)
    return apply_bcc(base, types, bonds)


# ---------------------------------------------------------------------------
# Amber-type -> BCC-type map (used by the fit over the embedded ff14SB
# residue templates, and by tests to cross-check graph typing).
# ---------------------------------------------------------------------------
AMBER_TO_BCC = {
    # carbons
    "CT": C_SP3, "CX": C_SP3, "2C": C_SP3, "3C": C_SP3, "C8": C_SP3,
    "CO": C_CARBONYL, "C": C_CARBONYL,
    "CA": C_AR, "CB": C_AR, "CC": C_AR, "CN": C_AR, "CR": C_AR,
    "CW": C_AR, "C*": C_AR, "CV": C_AR,
    # nitrogens
    "N": N_AMIDE, "N2": N_AMIDE, "N3": N_CHARGED,
    "NA": N_AR, "NB": N_AR,
    # oxygens
    "O": O_CARBONYL, "O2": O_CARBOXYLATE, "OH": O_SP3,
    # sulfur
    "S": S_ANY, "SH": S_ANY,
    # hydrogens by Amber type
    "H": H_N, "HO": H_O, "HS": H_S,
    "H1": H_C, "H4": H_C, "H5": H_C, "HA": H_C, "HC": H_C, "HP": H_C,
}
