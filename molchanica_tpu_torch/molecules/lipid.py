"""Procedural lipids + membranes (bilayers, liposome shells).

Copy of molchanica_tpu.molecules.lipid:
the same host code, so its results equal the reference's bit for bit.

Reference parity: src/molecules/lipid.rs — lipids from Amber Lipid21
head/tail templates, make_membrane (leaflet grids at the published
area-per-lipid: PC ~60-68 A^2), make_liposome, plus named compositions.
With no template files in this environment the phosphatidylcholine is
constructed procedurally (choline-phosphate-glycerol head + two saturated
acyl tails) with Lipid21-magnitude charges, neutralized exactly (PC is
zwitterionic, net 0).
"""
from __future__ import annotations

import copy
import math
from typing import List, Optional, Tuple

import numpy as np

from ..molecules.spec import MolSpec

AREA_PER_LIPID_PC = 64.0      # A^2 (fluid-phase PC, lipid.rs header)


def build_pc_lipid(tail_carbons: int = 14, seed: int = 0) -> MolSpec:
    """A phosphatidylcholine-like lipid, head at +z, tails toward -z.

    All-atom (~118 atoms for C14 tails): choline N(CH3)3-CH2-CH2-PO4-
    glycerol-(2 x acyl chain). Charges: head-group Lipid21-magnitude
    (zwitterionic), tails neutral.
    """
    masses, charges, sig, eps, pos = [], [], [], [], []
    bonds, angles, dihedrals, hclusters = [], [], [], []

    def add(el, q, s, e, p, m=None):
        i = len(masses)
        masses.append(m if m is not None else
                      {"C": 12.011, "H": 1.008, "O": 15.999,
                       "N": 14.007, "P": 30.974}[el])
        charges.append(q)
        sig.append(s)
        eps.append(e)
        pos.append(np.asarray(p, float))
        return i

    S_C, E_C = 3.40, 0.109
    S_H, E_H = 2.65, 0.0157
    S_O, E_O = 3.00, 0.17
    S_N, E_N = 3.25, 0.17
    S_P, E_P = 3.74, 0.20

    def add_h(parent, n_h, q=0.06, blen=1.09):
        out = []
        p = pos[parent]
        for k in range(n_h):
            ang = 2.0 * math.pi * k / max(n_h, 1) + 0.5
            h = add("H", q, S_H, E_H,
                    p + [0.9 * math.cos(ang), 0.9 * math.sin(ang), 0.35])
            bonds.append((parent, h, 340.0, blen))
            out.append(h)
        if out:
            hclusters.append((parent, out, [blen] * len(out)))
        return out

    # ---- choline: N+(CH3)3 - CH2 - CH2 - O ----
    z0 = 0.0
    n_i = add("N", -0.60, S_N, E_N, [0.0, 0.0, z0 + 7.6])
    for k in range(3):
        ang = 2.0 * math.pi * k / 3
        c = add("C", -0.10, S_C, E_C,
                [1.45 * math.cos(ang), 1.45 * math.sin(ang), z0 + 8.3])
        bonds.append((n_i, c, 367.0, 1.47))
        add_h(c, 3, q=0.12)
    c11 = add("C", -0.05, S_C, E_C, [0.0, 0.0, z0 + 6.1])
    bonds.append((n_i, c11, 367.0, 1.47))
    add_h(c11, 2, q=0.09)
    c12 = add("C", 0.10, S_C, E_C, [0.6, 0.6, z0 + 4.9])
    bonds.append((c11, c12, 310.0, 1.53))
    add_h(c12, 2, q=0.05)
    o_p1 = add("O", -0.50, S_O, E_O, [0.0, 0.3, z0 + 3.7])
    bonds.append((c12, o_p1, 320.0, 1.41))
    # ---- phosphate ----
    p_i = add("P", 1.25, S_P, E_P, [0.0, 0.0, z0 + 2.4])
    bonds.append((o_p1, p_i, 230.0, 1.60))
    for dxy in ((1.3, 0.4), (-1.3, 0.4)):
        o = add("O", -0.75, S_O, E_O, [dxy[0], dxy[1], z0 + 2.5])
        bonds.append((p_i, o, 525.0, 1.48))
    o_p2 = add("O", -0.50, S_O, E_O, [0.0, -0.4, z0 + 1.1])
    bonds.append((p_i, o_p2, 230.0, 1.60))
    # ---- glycerol backbone C1-C2-C3 ----
    g1 = add("C", 0.10, S_C, E_C, [0.3, 0.2, z0 + 0.0])
    bonds.append((o_p2, g1, 320.0, 1.41))
    add_h(g1, 2, q=0.05)
    g2 = add("C", 0.15, S_C, E_C, [-0.4, -0.4, z0 - 1.2])
    bonds.append((g1, g2, 310.0, 1.53))
    add_h(g2, 1, q=0.06)
    g3 = add("C", 0.10, S_C, E_C, [0.4, -0.9, z0 - 2.3])
    bonds.append((g2, g3, 310.0, 1.53))
    add_h(g3, 2, q=0.05)

    # ---- two ester-linked tails ----
    def tail(anchor, x_off):
        o_e = add("O", -0.45, S_O, E_O,
                  pos[anchor] + [x_off, 0.6, -1.0])
        bonds.append((anchor, o_e, 320.0, 1.41))
        c_c = add("C", 0.70, S_C, E_C, pos[o_e] + [0.3, 0.3, -1.2])
        bonds.append((o_e, c_c, 320.0, 1.36))
        o_d = add("O", -0.60, S_O, E_O, pos[c_c] + [1.1, 0.4, 0.2])
        bonds.append((c_c, o_d, 570.0, 1.23))
        prev = c_c
        for t in range(tail_carbons - 1):
            zig = 0.45 if t % 2 else -0.45
            c = add("C", 0.0, S_C, E_C,
                    pos[prev] + [zig * 0.5, zig, -1.18])
            bonds.append((prev, c, 310.0, 1.53))
            add_h(c, 2 if t < tail_carbons - 2 else 3, q=0.0)
            prev = c

    tail(g2, 1.2)
    tail(g3, -1.2)

    # exact neutralization over carbons
    resid = -sum(charges)
    cs = [i for i, m in enumerate(masses) if m > 11.0 and m < 13.0]
    for i in cs:
        charges[i] += resid / len(cs)

    # angles from connectivity (generic constants)
    adj = {}
    for (a, b, *_r) in bonds:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for j, nb in adj.items():
        for x in range(len(nb)):
            for y in range(x + 1, len(nb)):
                a, b = nb[x], nb[y]
                k = 35.0 if (masses[a] < 2 and masses[b] < 2) else 50.0
                angles.append((a, j, b, k, math.radians(109.5)))
    # generic 3-fold rotors along heavy-heavy bonds
    for (a, b, *_r) in bonds:
        if masses[a] > 2 and masses[b] > 2:
            na = [x for x in adj[a] if x != b and masses[x] > 2]
            nb2 = [x for x in adj[b] if x != a and masses[x] > 2]
            if na and nb2:
                dihedrals.append((na[0], a, b, nb2[0], 0.16, 3.0, 0.0))

    return MolSpec(
        masses=np.asarray(masses), charges=np.asarray(charges),
        lj_sigma=np.asarray(sig), lj_eps=np.asarray(eps),
        positions=np.asarray(pos), bonds=bonds, angles=angles,
        dihedrals=dihedrals, hclusters=hclusters,
        ff_mol_type="lipid")


def make_membrane(nx: int = 4, ny: int = 4,
                  area_per_lipid: float = AREA_PER_LIPID_PC,
                  tail_carbons: int = 14, seed: int = 0
                  ) -> Tuple[List[MolSpec], np.ndarray]:
    """Bilayer patch: two leaflets of nx*ny lipids each on a grid at the
    published area per lipid (reference make_membrane, lipid.rs:509).

    Returns (lipid MolSpecs, box_extent [3]); solvate with
    assemble_system(water_region=...) above/below the bilayer.
    """
    rng = np.random.default_rng(seed)
    base = build_pc_lipid(tail_carbons, seed)
    spacing = math.sqrt(area_per_lipid)
    lx, ly = nx * spacing, ny * spacing
    zmax = float(np.asarray(base.positions)[:, 2].max())
    zmin = float(np.asarray(base.positions)[:, 2].min())
    height = zmax - zmin
    mid = height + 1.0                    # leaflet tail-tail midplane
    lz = 2 * height + 30.0                # water slabs above/below
    mols = []
    for leaflet in (0, 1):
        for i in range(nx):
            for j in range(ny):
                m = copy.copy(base)
                p = np.asarray(base.positions).copy()
                th = rng.uniform(0, 2 * math.pi)
                c, s = math.cos(th), math.sin(th)
                R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
                p = (p - p.mean(0)) @ R.T + p.mean(0)
                if leaflet == 1:
                    p[:, 2] = -p[:, 2]    # flip: tails up
                    p[:, 2] += mid - zmax - 1.0
                else:
                    p[:, 2] += mid + 1.0 - zmin
                jit = rng.uniform(-0.6, 0.6, 2)
                p[:, 0] += (i + 0.5) * spacing + jit[0]
                p[:, 1] += (j + 0.5) * spacing + jit[1]
                p[:, 2] += 10.0           # bottom water pad
                m.positions = p
                mols.append(m)
    box = np.array([lx, ly, lz + 20.0])
    return mols, box
