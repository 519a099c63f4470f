"""Procedural nucleic acids: B-DNA / A-RNA construction from sequence.

Copy of molchanica_tpu.molecules.nucleic_acid:
the same host code, so its results equal the reference's bit for bit.

Reference parity: MoleculeNucleicAcid::from_seq
(src/molecules/nucleic_acid.rs:556) — the reference aligns
Amber template fragments along a helix (RISE 3.4 A, TWIST 34 deg, base-pair
H-bond distances ~2.85 A). With no template files in this environment the
bases are constructed analytically (planar polygons via the same ideal-
geometry machinery as the peptide builder), which yields geometrically
consistent, simulatable duplexes: planar paired bases on a 34 deg/3.4 A
helix, sugar-phosphate backbone with standard connectivity, net charge -1
per phosphate. Atom names follow PDB conventions so downstream typing and
IO work unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .common import MoleculeCommon

RISE = 3.4
TWIST = math.radians(34.0)
RISE_RNA = 2.8
TWIST_RNA = math.radians(32.7)

_CHI_BASE = 30.0
_BASE_MIRROR = -1.0     # in-plane glycosidic rotation (deg)
_COMPLEMENT_DNA = {"A": "T", "T": "A", "G": "C", "C": "G"}
_COMPLEMENT_RNA = {"A": "U", "U": "A", "G": "C", "C": "G"}

# ---------------------------------------------------------------------------
# Base geometries: built as planar polygons in the base plane (z=0 local),
# glycosidic N at the origin, ring extending toward -x (the helix axis side
# is +x). Returns (names, elements, xy, bonds, charges).
# Ring geometry: 6-ring side 1.37, 5-ring side 1.38 (aromatic C-N averages).
# Charges: curated Amber-magnitude values, normalized per-base to the
# fragment's formal charge.
# ---------------------------------------------------------------------------


def _polygon(n, side, start_angle=0.0):
    R = side / (2.0 * math.sin(math.pi / n))
    pts = []
    for k in range(n):
        th = start_angle + 2.0 * math.pi * k / n
        pts.append([R * math.cos(th) - R, R * math.sin(th)])
    return np.asarray(pts)



def _h_pair(parent_xy, radial_u, blen=1.01, half_deg=60.0):
    """Two H's symmetric about the radial direction (planar NH2)."""
    th = math.radians(half_deg)
    c, sn = math.cos(th), math.sin(th)
    perp = np.array([-radial_u[1], radial_u[0]])
    return (parent_xy + blen * (c * radial_u + sn * perp),
            parent_xy + blen * (c * radial_u - sn * perp))


def _base_pyrimidine(kind: str):
    """C, T, U: 6-ring N1 C2 N3 C4 C5 C6; N1 is glycosidic."""
    ring = _polygon(6, 1.37)
    names = ["N1", "C2", "N3", "C4", "C5", "C6"]
    elems = ["N", "C", "N", "C", "C", "C"]
    bonds = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)]
    xy = {n: ring[i] for i, n in enumerate(names)}

    def ext(anchor, dist):
        a = xy[anchor]
        c = np.array([-_ring_R6(), 0.0])
        u = (a - c) / np.linalg.norm(a - c)
        return a + u * dist

    extra = []
    if kind == "C":
        n4 = ext("C4", 1.34)
        u4 = (n4 - xy["C4"]) / np.linalg.norm(n4 - xy["C4"])
        h41, h42 = _h_pair(n4, u4)
        extra = [("O2", "O", ext("C2", 1.23), "C2"),
                 ("N4", "N", n4, "C4"),
                 ("H41", "H", h41, "N4"),
                 ("H42", "H", h42, "N4"),
                 ("H5", "H", ext("C5", 1.08), "C5"),
                 ("H6", "H", ext("C6", 1.08), "C6")]
        q = {"N1": -0.05, "C2": 0.75, "O2": -0.65, "N3": -0.75,
             "C4": 0.82, "N4": -0.95, "H41": 0.43, "H42": 0.43,
             "C5": -0.52, "H5": 0.19, "C6": 0.07, "H6": 0.23}
    elif kind == "T":
        extra = [("O2", "O", ext("C2", 1.23), "C2"),
                 ("O4", "O", ext("C4", 1.23), "C4"),
                 ("H3", "H", ext("N3", 1.01), "N3"),
                 ("C7", "C", ext("C5", 1.50), "C5"),
                 ("H71", "H", ext("C5", 2.59), "C7"),
                 ("H72", "H", _h_pair(ext("C5", 1.50),
                                      (ext("C5", 2.5) - ext("C5", 1.5))
                                      / 1.0, 1.09, 109.0)[0], "C7"),
                 ("H73", "H", _h_pair(ext("C5", 1.50),
                                      (ext("C5", 2.5) - ext("C5", 1.5))
                                      / 1.0, 1.09, 109.0)[1], "C7"),
                 ("H6", "H", ext("C6", 1.08), "C6")]
        q = {"N1": -0.02, "C2": 0.57, "O2": -0.59, "N3": -0.43,
             "H3": 0.32, "C4": 0.52, "O4": -0.56, "C5": 0.0,
             "C7": -0.23, "H71": 0.08, "H72": 0.08, "H73": 0.08,
             "C6": -0.22, "H6": 0.27}
    else:   # U
        extra = [("O2", "O", ext("C2", 1.23), "C2"),
                 ("O4", "O", ext("C4", 1.23), "C4"),
                 ("H3", "H", ext("N3", 1.01), "N3"),
                 ("H5", "H", ext("C5", 1.08), "C5"),
                 ("H6", "H", ext("C6", 1.08), "C6")]
        q = {"N1": 0.04, "C2": 0.47, "O2": -0.55, "N3": -0.35,
             "H3": 0.32, "C4": 0.59, "O4": -0.58, "C5": -0.36,
             "H5": 0.18, "C6": -0.11, "H6": 0.21}
    return names, elems, bonds, xy, extra, q


def _ring_R6(side=1.37):
    return side / (2.0 * math.sin(math.pi / 6))


def _base_purine(kind: str):
    """A, G: fused 6-ring (N1 C2 N3 C4 C5 C6) + 5-ring (C4 C5 N7 C8 N9);
    N9 is glycosidic."""
    six = _polygon(6, 1.37)
    names = ["N1", "C2", "N3", "C4", "C5", "C6"]
    elems = ["N", "C", "N", "C", "C", "C"]
    xy = {n: six[i] for i, n in enumerate(names)}
    bonds = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0)]
    # 5-ring fused on C4-C5 edge, pointing away from the 6-ring center
    c4, c5 = xy["C4"], xy["C5"]
    mid = 0.5 * (c4 + c5)
    center6 = np.array([-_ring_R6(), 0.0])
    out = mid - center6
    out = out / np.linalg.norm(out)
    side5 = 1.38
    R5 = side5 / (2.0 * math.sin(math.pi / 5))
    h5 = R5 * math.cos(math.pi / 5)
    c5c = mid + out * h5
    # remaining vertices N7 (near C5), C8, N9 (near C4)
    e = (c5 - c4) / np.linalg.norm(c5 - c4)

    def rot(v, th):
        c, s = math.cos(th), math.sin(th)
        return np.array([c * v[0] - s * v[1], s * v[0] + c * v[1]])

    v4 = c4 - c5c
    pts5 = [c4]
    for k in range(4):
        v4 = rot(v4, -2.0 * math.pi / 5)
        pts5.append(c5c + v4)
    # order around: C4 -> N9 -> C8 -> N7 -> C5 (choose direction s.t. the
    # last vertex coincides with C5)
    if np.linalg.norm(pts5[-1] - c5) > 0.5:
        v4 = c4 - c5c
        pts5 = [c4]
        for k in range(4):
            v4 = rot(v4, 2.0 * math.pi / 5)
            pts5.append(c5c + v4)
    xy["N9"], xy["C8"], xy["N7"] = pts5[1], pts5[2], pts5[3]
    for n, el in (("N9", "N"), ("C8", "C"), ("N7", "N")):
        names.append(n)
        elems.append(el)
    nid = {n: i for i, n in enumerate(names)}
    bonds += [(nid["C4"], nid["N9"]), (nid["N9"], nid["C8"]),
              (nid["C8"], nid["N7"]), (nid["N7"], nid["C5"])]

    def ext(anchor, dist, about=None):
        a = xy[anchor]
        c = np.array([-_ring_R6(), 0.0]) if about is None else about
        u = (a - c) / np.linalg.norm(a - c)
        return a + u * dist

    if kind == "A":
        n6 = ext("C6", 1.34)
        u6 = (n6 - xy["C6"]) / np.linalg.norm(n6 - xy["C6"])
        h61, h62 = _h_pair(n6, u6)
        extra = [("N6", "N", n6, "C6"),
                 ("H61", "H", h61, "N6"),
                 ("H62", "H", h62, "N6"),
                 ("H2", "H", ext("C2", 1.08), "C2"),
                 ("H8", "H", ext("C8", 1.08, c5c), "C8")]
        q = {"N1": -0.76, "C2": 0.57, "H2": 0.07, "N3": -0.74,
             "C4": 0.38, "C5": 0.07, "C6": 0.69, "N6": -0.91,
             "H61": 0.42, "H62": 0.42, "N7": -0.62, "C8": 0.16,
             "H8": 0.19, "N9": 0.03}
    else:   # G
        extra = [("O6", "O", ext("C6", 1.23), "C6"),
                 ("H1", "H", ext("N1", 1.01), "N1"),
                 ("N2", "N", ext("C2", 1.34), "C2"),
                 ("H21", "H", _h_pair(ext("C2", 1.34),
                                      (ext("C2", 2.3) - ext("C2", 1.3))
                                      / np.linalg.norm(
                                          ext("C2", 2.3) - ext("C2", 1.3)))[0],
                  "N2"),
                 ("H22", "H", _h_pair(ext("C2", 1.34),
                                      (ext("C2", 2.3) - ext("C2", 1.3))
                                      / np.linalg.norm(
                                          ext("C2", 2.3) - ext("C2", 1.3)))[1],
                  "N2"),
                 ("H8", "H", ext("C8", 1.08, c5c), "C8")]
        q = {"N1": -0.48, "H1": 0.34, "C2": 0.77, "N2": -0.97,
             "H21": 0.41, "H22": 0.41, "N3": -0.66, "C4": 0.18,
             "C5": 0.20, "C6": 0.49, "O6": -0.57, "N7": -0.57,
             "C8": 0.14, "H8": 0.16, "N9": 0.05}
    # re-anchor: glycosidic N9 at the origin, ring centroid toward -x
    n9 = xy["N9"].copy()
    for k in xy:
        xy[k] = xy[k] - n9
    cen = np.mean([xy[k] for k in ("N1", "C2", "N3", "C4", "C5", "C6",
                                   "N7", "C8")], axis=0)
    phi = math.atan2(cen[1], cen[0])
    c_r, s_r = math.cos(math.pi - phi), math.sin(math.pi - phi)
    for k in xy:
        v = xy[k]
        xy[k] = np.array([c_r * v[0] - s_r * v[1],
                          s_r * v[0] + c_r * v[1]])
    extra = [(nm, el, np.array(
        [c_r * (np.asarray(p2) - n9)[0] - s_r * (np.asarray(p2) - n9)[1],
         s_r * (np.asarray(p2) - n9)[0] + c_r * (np.asarray(p2) - n9)[1]]),
        par) for nm, el, p2, par in extra]
    return names, elems, bonds, xy, extra, q


_TEMPLATE_CACHE: Dict[Tuple[float, float], Dict[str, np.ndarray]] = {}


def _backbone_template(rise: float, twist: float) -> Dict[str, np.ndarray]:
    """Solve a canonical sugar-phosphate local geometry numerically, once.

    Local frame: glycosidic N at the origin, x = outward radial,
    y = tangential (5'->3'), z = helix axis (5'->3'). The optimizer
    satisfies covalent bond lengths, furanose ring closure, nonbonded
    spacing, AND the helical-symmetry phosphate bridge: the PREVIOUS
    residue's O3' (this template rotated by -twist, dropped by -rise about
    the axis at x = -r_gly... handled via the exact cylindrical transform)
    must sit 1.60 A from this residue's P.
    """
    key = (round(rise, 4), round(twist, 4))
    if key in _TEMPLATE_CACHE:
        return _TEMPLATE_CACHE[key]
    from scipy.optimize import minimize

    r_gly = 4.9
    names = ["C1'", "C2'", "C3'", "C4'", "O4'", "C5'", "O5'", "O3'",
             "P", "OP1", "OP2"]
    x0 = np.array([
        [1.47, 0.0, 0.0],       # C1'
        [2.20, -0.9, -0.6],     # C2'
        [3.55, -0.6, -0.2],     # C3'
        [3.60, 0.4, 0.9],       # C4'
        [2.35, 0.9, 0.7],       # O4'
        [4.70, 1.3, 1.3],       # C5'
        [4.80, 1.6, 2.7],       # O5'
        [4.60, -1.6, 0.2],      # O3'
        [5.10, 1.0, 3.9],       # P (of the NEXT... bridging prev O3')
        [6.40, 1.4, 4.3],       # OP1
        [4.60, 0.3, 5.0],       # OP2
    ])
    bonds = [("C1'", "C2'", 1.53), ("C2'", "C3'", 1.53),
             ("C3'", "C4'", 1.53), ("C4'", "O4'", 1.45),
             ("O4'", "C1'", 1.42), ("C4'", "C5'", 1.51),
             ("C5'", "O5'", 1.44), ("C3'", "O3'", 1.42),
             ("P", "O5'", 1.60), ("P", "OP1", 1.48), ("P", "OP2", 1.48)]
    ni = {n: i for i, n in enumerate(names)}

    def world(p):
        """local -> cylindrical world at theta=0 (axis at -r_gly x)."""
        return np.array([p[0] + r_gly, p[1], p[2]])

    def rot_z(p, th):
        c, s = math.cos(th), math.sin(th)
        return np.array([c * p[0] - s * p[1], s * p[0] + c * p[1], p[2]])

    def loss(v):
        p = v.reshape(-1, 3)
        L = 0.0
        for a, b, d0 in bonds:
            d = np.linalg.norm(p[ni[a]] - p[ni[b]])
            L += (d - d0) ** 2 * 25.0
        # glycosidic C1'-N bond (origin)
        L += (np.linalg.norm(p[ni["C1'"]]) - 1.47) ** 2 * 25.0
        # helical phosphate bridge: prev O3' (rotated -twist, -rise)
        o3_prev = rot_z(world(p[ni["O3'"]]), -twist) \
            - np.array([0.0, 0.0, rise])
        L += (np.linalg.norm(o3_prev - world(p[ni["P"]])) - 1.60) ** 2 \
            * 25.0
        # soft nonbonded spacing within the template
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                if any({names[i], names[j]} == {a, b} for a, b, _ in bonds):
                    continue
                d = np.linalg.norm(p[i] - p[j])
                if d < 2.2:
                    L += (2.2 - d) ** 2 * 8.0
        # stay outside the base plane region and near the start layout
        L += np.sum(np.maximum(0.8 - p[:, 0], 0.0) ** 2) * 10.0
        L += np.sum((p - x0) ** 2) * 0.01
        return L

    res = minimize(loss, x0.ravel(), method="L-BFGS-B",
                   options={"maxiter": 2000})
    p = res.x.reshape(-1, 3)
    out = {n: p[ni[n]] for n in names}
    # hydrogens: simple perpendicular offsets from their carbons
    def h_off(cn, others, blen=1.09):
        c = out[cn]
        u = np.zeros(3)
        for o in others:
            u += c - out[o]
        nu = np.linalg.norm(u)
        u = u / nu if nu > 1e-6 else np.array([0.0, 0.0, 1.0])
        return c + u * blen
    # H1' must also avoid the glycosidic N at the local origin
    u1 = (out["C1'"] - out["C2'"]) + (out["C1'"] - out["O4'"]) \
        + out["C1'"]
    out["H1'"] = out["C1'"] + u1 / np.linalg.norm(u1) * 1.09
    out["H2'"] = h_off("C2'", ["C1'", "C3'"]) + np.array([0, 0.3, 0.3])
    out["H2''"] = h_off("C2'", ["C1'", "C3'"]) - np.array([0, 0.3, 0.3])
    out["H3'"] = h_off("C3'", ["C2'", "C4'", "O3'"])
    out["H4'"] = h_off("C4'", ["C3'", "O4'", "C5'"])
    out["H5'"] = h_off("C5'", ["C4'", "O5'"]) + np.array([0, 0.4, 0])
    out["H5''"] = h_off("C5'", ["C4'", "O5'"]) - np.array([0, 0.5, 0.2])
    _TEMPLATE_CACHE[key] = out
    return out


_SUGAR_Q = {"C1'": 0.12, "H1'": 0.10, "C2'": -0.09, "H2'": 0.07,
            "H2''": 0.07, "O2'": -0.61, "HO2'": 0.42,
            "C3'": 0.07, "H3'": 0.10, "C4'": 0.11, "H4'": 0.12,
            "O4'": -0.37, "C5'": -0.01, "H5'": 0.07, "H5''": 0.07,
            "O5'": -0.50, "O3'": -0.52,
            "P": 1.17, "OP1": -0.78, "OP2": -0.78}


def _glycosidic(kind: str) -> str:
    return "N9" if kind in ("A", "G") else "N1"


def build_strand(seq: str, kind: str = "dna", phase0: float = 0.0,
                 z0: float = 0.0, direction: int = 1, chain: str = "A",
                 resi0: int = 1, anti: bool = False):
    """One strand along +z. Returns per-atom lists + bonds (local idx)."""
    rna = kind.lower() == "rna"
    rise = RISE_RNA if rna else RISE
    twist = TWIST_RNA if rna else TWIST
    names_o: List[str] = []
    elems_o: List[str] = []
    pos_o: List[np.ndarray] = []
    resn_o: List[str] = []
    resi_o: List[int] = []
    q_o: List[float] = []
    bonds_o: List[Tuple[int, int]] = []
    prev_o3 = None
    r_gly = 4.9        # glycosidic N distance from the helix axis

    for si, base in enumerate(seq.upper()):
        res_base = len(names_o)
        theta = phase0 + direction * twist * si
        z = z0 + direction * rise * si
        # local base frame: glycosidic N at radius r_gly, base plane ~ xy
        if base in ("A", "G"):
            bn, be, bb, xy, extra, q = _base_purine(base)
        else:
            bn, be, bb, xy, extra, q = _base_pyrimidine(base)
        gly = _glycosidic(base)

        def place(p2, flip=anti):
            """Base-plane (u, v) -> world. Base ring coordinates extend
            toward local -x; an in-plane rotation chi about the glycosidic
            N turns the head-on edge into the offset-parallel Watson-Crick
            alignment (the base-pair dyad maps strand B consistently)."""
            chi = math.radians(_CHI_BASE) * (-1.0 if flip else 1.0)
            c_chi, s_chi = math.cos(chi), math.sin(chi)
            y0 = p2[1] * _BASE_MIRROR
            px = c_chi * p2[0] - s_chi * y0
            py = s_chi * p2[0] + c_chi * y0
            u = np.array([math.cos(theta), math.sin(theta), 0.0])
            v = np.array([-math.sin(theta), math.cos(theta), 0.0]) \
                * (-1.0 if flip else 1.0)
            origin = u * r_gly + np.array([0.0, 0.0, z])
            return origin + u * px + v * py

        base_idx: Dict[str, int] = {}
        for n2, e2 in zip(bn, be):
            base_idx[n2] = len(names_o)
            names_o.append(n2)
            elems_o.append(e2)
            pos_o.append(place(xy[n2]))
            q_o.append(q.get(n2, 0.0))
        for i, j in bb:
            bonds_o.append((res_base + i, res_base + j))
        for n2, e2, p2, parent in extra:
            base_idx[n2] = len(names_o)
            names_o.append(n2)
            elems_o.append(e2)
            pos_o.append(place(np.asarray(p2)))
            q_o.append(q.get(n2, 0.0))
            bonds_o.append((base_idx[n2], base_idx[parent]))

        # sugar ring C1'..O4' placed outward of the glycosidic N
        out_dir = np.array([math.cos(theta), math.sin(theta), 0.0])
        tang = np.array([-math.sin(theta), math.cos(theta), 0.0]) \
            * direction
        gpos = pos_o[base_idx[gly]]
        sug: Dict[str, int] = {}

        def add(nm, el, p, qv=None, parent=None):
            sug[nm] = len(names_o)
            names_o.append(nm)
            elems_o.append(el)
            pos_o.append(np.asarray(p, float))
            q_o.append(_SUGAR_Q.get(nm, 0.0) if qv is None else qv)
            if parent is not None:
                bonds_o.append((sug[nm], sug[parent] if isinstance(
                    parent, str) else parent))

        tpl = _backbone_template(rise, twist)
        up = np.array([0.0, 0.0, float(direction)])

        def placeb(p3):
            """Backbone template local (x=out, y=tangential, z=5'->3')."""
            return (gpos + out_dir * p3[0] + tang * p3[1] + up * p3[2])

        for nm, el, parent in (
                ("C1'", "C", None), ("H1'", "H", "C1'"),
                ("C2'", "C", "C1'"), ("H2'", "H", "C2'"),
                ("C3'", "C", "C2'"), ("H3'", "H", "C3'"),
                ("C4'", "C", "C3'"), ("H4'", "H", "C4'"),
                ("O4'", "O", "C4'"), ("C5'", "C", "C4'"),
                ("H5'", "H", "C5'"), ("H5''", "H", "C5'"),
                ("O5'", "O", "C5'"), ("O3'", "O", "C3'")):
            add(nm, el, placeb(tpl[nm]),
                parent=base_idx[gly] if nm == "C1'" else parent)
        bonds_o.append((sug["O4'"], sug["C1'"]))
        if not rna:
            add("H2''", "H", placeb(tpl["H2''"]), parent="C2'")
        if rna:
            c2w = placeb(tpl["C2'"])
            o2 = c2w + out_dir * 1.0 - up * 1.0
            add("O2'", "O", o2, parent="C2'")
            add("HO2'", "H", o2 + tang * 0.9, parent="O2'")

        # phosphate bridging the PREVIOUS residue's O3' to this O5'
        if prev_o3 is not None:
            p_pos = placeb(tpl["P"])
            add("P", "P", p_pos, parent=None)
            bonds_o.append((sug["P"], prev_o3))
            bonds_o.append((sug["P"], sug["O5'"]))
            add("OP1", "O", placeb(tpl["OP1"]), parent="P")
            add("OP2", "O", placeb(tpl["OP2"]), parent="P")
        prev_o3 = sug["O3'"]

        rn = ("D" + base) if not rna else base
        for _ in range(len(names_o) - res_base):
            resn_o.append(rn)
            resi_o.append(resi0 + si)
    chains = [chain] * len(names_o)
    return names_o, elems_o, pos_o, q_o, bonds_o, resn_o, resi_o, chains


@dataclass
class MoleculeNucleicAcid:
    """Reference MoleculeNucleicAcid analog (nucleic_acid.rs:113)."""
    common: MoleculeCommon
    kind: str               # "dna" | "rna"
    seq: str
    double_stranded: bool

    @staticmethod
    def from_seq(seq: str, kind: str = "dna", double: bool = True
                 ) -> "MoleculeNucleicAcid":
        seq = seq.upper().replace("U", "U") if kind == "rna" else \
            seq.upper().replace("U", "T")
        comp = _COMPLEMENT_RNA if kind == "rna" else _COMPLEMENT_DNA
        parts = [build_strand(seq, kind, chain="A")]
        if double:
            # antiparallel complement: reversed sequence, opposite z
            # direction, phase offset so paired glycosidic N's face each
            # other across the axis (~2 * r_gly - H-bond span apart)
            cseq = "".join(comp[c] for c in reversed(seq))
            n = len(seq)
            rise = RISE_RNA if kind == "rna" else RISE
            twist = TWIST_RNA if kind == "rna" else TWIST
            parts.append(build_strand(
                cseq, kind, phase0=math.pi + twist * (n - 1),
                z0=rise * (n - 1), direction=-1, chain="B",
                resi0=len(seq) + 1, anti=True))
        names, elems, pos, qs, bonds, resn, resi, chains = \
            [], [], [], [], [], [], [], []
        for p in parts:
            off = len(names)
            names += p[0]
            elems += p[1]
            pos += p[2]
            qs += p[3]
            bonds += [(a + off, b + off) for a, b in p[4]]
            resn += p[5]
            resi += p[6]
            chains += p[7]
        mol = MoleculeCommon(
            elements=elems, positions=np.asarray(pos), bonds=sorted(bonds),
            atom_names=names, res_names=resn, res_ids=resi, chains=chains,
            charges=np.asarray(qs),
            hetero=[False] * len(names),
            name=f"{kind.upper()}:{seq}")
        return MoleculeNucleicAcid(common=mol, kind=kind, seq=seq,
                                   double_stranded=double)

    def to_spec(self):
        """Parameterized MolSpec: per-atom charges from the curated tables
        (normalized to -1 per phosphate), generic bonded constants via
        assign_params fallbacks."""
        from ..ff.data.protein_ff14sb import PROTEIN_FF
        from ..ff.params import assign_params

        mol = self.common
        # type mapping by element/name
        types = []
        for nm, el in zip(mol.atom_names, mol.elements):
            if el == "P":
                types.append("P")
            elif el == "H":
                types.append("H1" if "'" in nm else "H")
            elif el == "O":
                types.append("OH" if "'" in nm else "O")
            elif el == "N":
                types.append("N")
            elif "'" in nm:
                types.append("CT")
            else:
                types.append("CA")
        # normalize net charge to the formal count (-1 per phosphate)
        n_p = sum(1 for e in mol.elements if e == "P")
        qs = np.asarray(mol.charges, float).copy()
        resid = (-float(n_p)) - qs.sum()
        heavy = [i for i, e in enumerate(mol.elements) if e != "H"]
        qs[heavy] += resid / len(heavy)
        ff = PROTEIN_FF
        # P parameters are absent from the protein table; extend on the fly
        if "P" not in ff.nonbonded:
            ff = type(ff)(masses=dict(ff.masses), bonds=dict(ff.bonds),
                          angles=dict(ff.angles),
                          dihedrals=dict(ff.dihedrals),
                          impropers=dict(ff.impropers),
                          nonbonded=dict(ff.nonbonded),
                          equivalences=dict(ff.equivalences),
                          title=ff.title + " + nucleic subset")
            ff.masses["P"] = 30.97
            ff.nonbonded["P"] = (2.10, 0.20)
        spec = assign_params(mol.elements, types, qs, mol.positions,
                             mol.bonds, ff, ff_mol_type="dna",
                             strict=False)
        return spec
