"""Procedural peptide construction from sequence.

Copy of molchanica_tpu.molecules.peptide_builder:
the same host code, so its results equal the reference's bit for bit.

Reference analog: the procedural molecule builders
(src/molecules/ peptide/NA builders). Builds an extended
(beta-strand-like) backbone from ideal internal coordinates, then completes
side-chain heavy atoms + hydrogens with the same ideal-geometry placement
pass used by H-addition (molecules/peptide.py)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..ff.data.protein_ff14sb import RESIDUE_ALIASES, RESIDUE_TEMPLATES
from .common import MoleculeCommon

AA1_TO_3 = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}


def build_peptide(sequence: str, phi=-135.0, psi=135.0) -> MoleculeCommon:
    """Heavy-atom peptide in an extended conformation.

    sequence: 1-letter codes. Returns MoleculeCommon with ALL heavy atoms
    (side chains placed by ideal geometry) and no hydrogens — feed to
    prepare_peptide for H's + parameters.

    phi/psi: scalar backbone dihedrals, or per-residue arrays [len(seq)]
    (used by structure_prediction's secondary-structure baseline).
    """
    seq3 = [AA1_TO_3[c.upper()] for c in sequence]
    phi_a = np.broadcast_to(np.asarray(phi, float), (len(seq3),))
    psi_a = np.broadcast_to(np.asarray(psi, float), (len(seq3),))
    elements: List[str] = []
    names: List[str] = []
    resn: List[str] = []
    resi: List[int] = []
    pos: List[np.ndarray] = []
    bonds = []

    # ideal backbone geometry
    b_NCa, b_CaC, b_CN, b_CO = 1.458, 1.525, 1.329, 1.231
    ang = np.deg2rad(121.0)

    def extend(p1, p2, p3, blen, theta_deg, chi_deg):
        """NeRF: place p4 given three previous atoms + internal coords."""
        theta = np.deg2rad(theta_deg)
        chi = np.deg2rad(chi_deg)
        b1 = p2 - p1
        b2 = p3 - p2
        n = np.cross(b1, b2)
        n /= max(np.linalg.norm(n), 1e-9)
        m = np.cross(n, b2 / max(np.linalg.norm(b2), 1e-9))
        d = np.array([-blen * np.cos(theta),
                      blen * np.sin(theta) * np.cos(chi),
                      blen * np.sin(theta) * np.sin(chi)])
        M = np.stack([b2 / max(np.linalg.norm(b2), 1e-9), m, n], axis=1)
        return p3 + M @ d

    prev = {}
    for r, rn in enumerate(seq3):
        tpl = RESIDUE_TEMPLATES[RESIDUE_ALIASES.get(rn, rn)]
        base = len(names)
        if r == 0:
            N = np.zeros(3)
            CA = N + np.array([b_NCa, 0, 0])
            C = CA + b_CaC * np.array([np.cos(np.pi - ang),
                                       np.sin(np.pi - ang), 0])
        else:
            N = extend(prev["N"], prev["CA"], prev["C"], b_CN, 116.6,
                       psi_a[r - 1])
            CA = extend(prev["CA"], prev["C"], N, b_NCa, 121.9, 180.0)
            C = extend(prev["C"], N, CA, b_CaC, 110.1, phi_a[r])
        O = extend(N, CA, C, b_CO, 120.4, psi_a[r] + 180.0)

        coords = {"N": N, "CA": CA, "C": C, "O": O}
        for nm, ty, _q in tpl["atoms"]:
            if nm.startswith("H"):
                continue
            names.append(nm)
            elements.append(_elem_of(nm))
            resn.append(rn)
            resi.append(r + 1)
            pos.append(coords.get(nm))       # side chains placed below
        prev = {"N": N, "CA": CA, "C": C}

    # complete side-chain heavy atoms via the shared placement pass
    from .peptide import _place_missing

    # intra-residue bonds from templates (heavy only), renumbered
    name_rows = list(zip(names, resi))
    index = {}
    for i, nr in enumerate(name_rows):
        index[nr] = i
    for r, rn in enumerate(seq3):
        tpl = RESIDUE_TEMPLATES[RESIDUE_ALIASES.get(rn, rn)]
        t_names = [a[0] for a in tpl["atoms"]]
        for i, j in tpl["bonds"]:
            a, b = t_names[i], t_names[j]
            if a.startswith("H") or b.startswith("H"):
                continue
            ka, kb = index.get((a, r + 1)), index.get((b, r + 1))
            if ka is not None and kb is not None:
                bonds.append((ka, kb))
        if r + 1 < len(seq3):
            ka, kb = index.get(("C", r + 1)), index.get(("N", r + 2))
            if ka is not None and kb is not None:
                bonds.append((ka, kb))

    pos = _place_missing(names, elements, pos, bonds)
    pos = _fix_rings(names, resn, resi, pos, seq3)
    return MoleculeCommon(
        elements=elements, positions=np.asarray(pos), bonds=sorted(
            set((min(i, j), max(i, j)) for i, j in bonds)),
        atom_names=names, res_names=resn, res_ids=resi,
        chains=["A"] * len(names), hetero=[False] * len(names),
        name=f"peptide:{sequence}")


def _rodrigues(v, axis, theta):
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    return (v * np.cos(theta) + np.cross(axis, v) * np.sin(theta)
            + axis * (axis @ v) * (1 - np.cos(theta)))


def _ring_anchor(center_atom, away_from, cycle_len, side):
    """Regular n-gon with one vertex at `center_atom`, ring center along
    the direction away from `away_from`. Returns all n vertices, vertex 0 =
    the anchor."""
    R = side / (2.0 * np.sin(np.pi / cycle_len))
    u = center_atom - away_from
    u = u / max(np.linalg.norm(u), 1e-9)
    ref = np.array([0.0, 0.0, 1.0])
    if abs(u @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    w = np.cross(u, ref)
    w /= max(np.linalg.norm(w), 1e-9)
    c = center_atom + R * u
    verts = []
    for k in range(cycle_len):
        th = 2 * np.pi * k / cycle_len
        verts.append(c - R * np.cos(th) * u + R * np.sin(th) * w)
    return verts


def _ring_from_edge(v1, v2, cycle_len, away_from):
    """Regular n-gon sharing the edge (v1, v2); remaining vertices continue
    v1 -> v2 -> ... on the side away from `away_from`."""
    side = float(np.linalg.norm(v2 - v1))
    R = side / (2.0 * np.sin(np.pi / cycle_len))
    h = R * np.cos(np.pi / cycle_len)
    mid = 0.5 * (v1 + v2)
    e = (v2 - v1) / max(side, 1e-9)
    # in-plane perpendicular pointing away from `away_from`
    m0 = mid - away_from
    m = m0 - (m0 @ e) * e
    nm = np.linalg.norm(m)
    if nm < 1e-6:
        m = np.array([0.0, 0.0, 1.0]) - e * e[2]
        nm = np.linalg.norm(m)
    m /= nm
    c = mid + h * m
    axis = np.cross(v1 - c, v2 - c)
    verts = [v1, v2]
    cur = v2
    for _ in range(cycle_len - 2):
        cur = c + _rodrigues(cur - c, axis, 2 * np.pi / cycle_len)
        verts.append(cur)
    return verts


_RING_CYCLES = {
    "PHE": [("CB", ["CG", "CD1", "CE1", "CZ", "CE2", "CD2"])],
    "TYR": [("CB", ["CG", "CD1", "CE1", "CZ", "CE2", "CD2"])],
    "HIS": [("CB", ["CG", "ND1", "CE1", "NE2", "CD2"])],
    "TRP": [("CB", ["CG", "CD1", "NE1", "CE2", "CD2"])],   # + fused hexagon
}


def _fix_rings(names, resn, resi, pos, seq3):
    """Replace greedily-placed ring heavy atoms with exact planar
    polygons (greedy sequential placement cannot close cycles)."""
    pos = np.asarray(pos, float).copy()
    index = {}
    for i, (nm, r) in enumerate(zip(names, resi)):
        index[(nm, r)] = i
    for r, rn in enumerate(seq3):
        rid = r + 1
        cycles = _RING_CYCLES.get(RESIDUE_ALIASES.get(rn, rn), [])
        for away_name, cycle in cycles:
            ids = [index.get((nm, rid)) for nm in cycle]
            away = index.get((away_name, rid))
            if any(i is None for i in ids) or away is None:
                continue
            side = 1.39 if len(cycle) == 6 else 1.37
            verts = _ring_anchor(pos[ids[0]], pos[away], len(cycle), side)
            for i, v in zip(ids, verts):
                pos[i] = v
            # re-place exocyclic heavy substituents (TYR OH) radially
            oh = index.get(("OH", rid))
            cz = index.get(("CZ", rid))
            if oh is not None and cz is not None and cz in ids:
                center = np.mean([pos[i] for i in ids], axis=0)
                u = pos[cz] - center
                u /= max(np.linalg.norm(u), 1e-9)
                pos[oh] = pos[cz] + 1.364 * u
        if RESIDUE_ALIASES.get(rn, rn) == "TRP":
            hexa = ["CD2", "CE2", "CZ2", "CH2", "CZ3", "CE3"]
            ids = [index.get((nm, rid)) for nm in hexa]
            cg = index.get(("CG", rid))
            if not any(i is None for i in ids) and cg is not None:
                verts = _ring_from_edge(pos[ids[0]], pos[ids[1]], 6,
                                        pos[cg])
                for i, v in zip(ids, verts):
                    pos[i] = v
        if RESIDUE_ALIASES.get(rn, rn) == "PRO":
            cyc = ["CA", "N", "CD", "CG", "CB"]
            ids = [index.get((nm, rid)) for nm in cyc]
            c_id = index.get(("C", rid))
            if not any(i is None for i in ids) and c_id is not None:
                verts = _ring_from_edge(pos[ids[0]], pos[ids[1]], 5,
                                        pos[c_id])
                for i, v in zip(ids[2:], verts[2:]):
                    pos[i] = v
    return pos


def _elem_of(atom_name: str) -> str:
    for e in ("CL", "BR"):
        if atom_name.upper().startswith(e):
            return e.capitalize()
    c = atom_name[0]
    return {"N": "N", "C": "C", "O": "O", "S": "S", "H": "H"}.get(c, c)
