"""1-octanol solvent: molecule template + box packing (numpy copy of
molchanica_tpu.systems.octanol: the same seeded draws, so the arrays equal
the reference's).

Reference: the octanol/water mixed solvent used by the LogP workload
(src/properties/logp.rs:28-45 — 356 octanol per 46 A cube,
0.38 water per octanol ~ 27 mol% water, the standard "wet octanol"
partition medium). Parameters are hand-authored GAFF2-magnitude constants
(same approach as systems/bench_systems.py): CT/H1/HC/OH/HO types.
"""
from __future__ import annotations

import math

import numpy as np

from ..molecules.spec import MolSpec

# density bookkeeping from the reference
OCTANOL_PER_UNIT_VOL = 356.0 / 46.0 ** 3       # molecules / A^3
WATER_PER_OCTANOL = 0.38

# charges: alcohol head (AMBER-alcohol-magnitude), alkane tail neutral
_Q_O, _Q_HO, _Q_C1, _Q_H1 = -0.598, 0.396, 0.146, 0.028


def build_octanol(seed: int = 0) -> MolSpec:
    """All-atom 1-octanol (C8H17OH, 27 atoms) in an extended conformation."""
    rng = np.random.default_rng(seed)
    n_c = 8
    masses, charges, sig, eps, pos = [], [], [], [], []
    bonds, angles, dihedrals = [], [], []
    idx_c = []
    # zig-zag carbon chain along x
    for i in range(n_c):
        idx_c.append(len(masses))
        masses.append(12.011)
        q = _Q_C1 if i == 0 else 0.0
        charges.append(q)
        sig.append(1.9080 * 2 / 2 ** (1 / 6))
        eps.append(0.1094)
        pos.append([1.26 * i, 0.44 * (i % 2), 0.0])
    # hydroxyl on C1
    i_o = len(masses)
    masses.append(15.999)
    charges.append(_Q_O)
    sig.append(1.7210 * 2 / 2 ** (1 / 6))
    eps.append(0.2104)
    pos.append([-0.9, -1.0, 0.0])
    i_ho = len(masses)
    masses.append(1.008)
    charges.append(_Q_HO)
    sig.append(0.0)
    eps.append(0.0)
    pos.append([-0.6, -1.9, 0.0])
    bonds.append((idx_c[0], i_o, 320.0, 1.410))
    bonds.append((i_o, i_ho, 553.0, 0.960))
    # C-C bonds
    for i in range(n_c - 1):
        bonds.append((idx_c[i], idx_c[i + 1], 310.0, 1.526))
    # hydrogens: 2 per CH2 (C1..C7), 3 on the terminal CH3
    h_of = {}
    for i in range(n_c):
        n_h = 2 if i < n_c - 1 else 3
        h_of[i] = []
        for k in range(n_h):
            j = len(masses)
            h_of[i].append(j)
            masses.append(1.008)
            charges.append(_Q_H1 if i == 0 else 0.0)
            sig.append((1.3870 if i == 0 else 1.4870) * 2 / 2 ** (1 / 6))
            eps.append(0.0157)
            ang = 2.0 * math.pi * k / n_h + (0.7 if i % 2 else 0.0)
            pos.append([1.26 * i + 0.36,
                        0.44 * (i % 2) + 0.9 * math.cos(ang),
                        0.9 * math.sin(ang)])
            bonds.append((idx_c[i], j, 340.0, 1.090))
    # neutralize exactly (spread tiny residual over carbons)
    resid = -sum(charges) / n_c
    for i in idx_c:
        charges[i] += resid

    # angles: derive from bonds
    adj = {}
    for (a, b, *_r) in bonds:
        adj.setdefault(a, []).append(b)
        adj.setdefault(b, []).append(a)
    for j, nbrs in adj.items():
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                a, b = nbrs[x], nbrs[y]
                if j == i_o:
                    k, th = 55.0, 108.5
                elif masses[a] < 2 and masses[b] < 2:
                    k, th = 35.0, 109.5
                else:
                    k, th = 50.0, 109.5
                angles.append((a, j, b, k, th * math.pi / 180.0))
    # torsions: generic 3-fold along the C-C chain
    for i in range(n_c - 3):
        dihedrals.append((idx_c[i], idx_c[i + 1], idx_c[i + 2],
                          idx_c[i + 3], 0.18, 3.0, 0.0))

    hclusters = [(idx_c[i], list(h_of[i]), [1.090] * len(h_of[i]))
                 for i in range(n_c)] + [(i_o, [i_ho], [0.960])]
    return MolSpec(
        masses=np.asarray(masses), charges=np.asarray(charges),
        lj_sigma=np.asarray(sig), lj_eps=np.asarray(eps),
        positions=np.asarray(pos), bonds=bonds, angles=angles,
        dihedrals=dihedrals, hclusters=hclusters,
        ff_mol_type="small_organic")


def pack_octanol_box(box_side: float, density_scale: float = 0.85,
                     water_fraction: float = 0.27, seed: int = 0):
    """Grid-packed octanol molecules for a cubic box; returns (list of
    positioned octanol MolSpecs, n_water) — feed to assemble_system with
    the water model filling the n_water slots.

    density_scale < 1 under-fills slightly: the synthetic extended
    conformers need room; NPT or long NVT equilibration closes the gap.
    """
    rng = np.random.default_rng(seed)
    vol = box_side ** 3
    n_oct = max(int(OCTANOL_PER_UNIT_VOL * vol * density_scale), 1)
    n_water = int(n_oct * water_fraction / max(1.0 - water_fraction, 1e-9)
                  * 1.0)
    base = build_octanol(seed)
    # cubic lattice with one octanol per cell, random axis + flip
    n_side = max(int(math.ceil(n_oct ** (1 / 3))), 1)
    spacing = box_side / n_side
    mols = []
    cells = [(i, j, k) for i in range(n_side) for j in range(n_side)
             for k in range(n_side)]
    rng.shuffle(cells)
    for (i, j, k) in cells[:n_oct]:
        m = base
        # random proper rotation
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        import copy
        m2 = copy.copy(m)
        com = np.asarray(base.positions).mean(axis=0)
        m2.positions = (np.asarray(base.positions) - com) @ R.T + \
            (np.array([i, j, k]) + 0.5) * spacing
        mols.append(m2)
    return mols, n_water
