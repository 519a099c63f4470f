"""Benchmark system builders (BASELINE.md configs).

Self-contained: parameters are hand-authored Amber-magnitude constants
(public ff14SB/ff19SB-family values for alanine), so the benchmark needs no
external force-field files. The real parameter pipeline for user systems
lives in molchanica_tpu.ff (Amber .dat/.frcmod/.lib parsers + typing).

Config 3 (the north-star metric): a compact polyalanine chain solvated in
OPC water, ~25k atom sites, NVT. Copy of molchanica_tpu.systems.bench_systems
(build_polyalanine and build_solvated_protein only).
"""
from __future__ import annotations

import math

import numpy as np

from ..molecules.spec import MolSpec, assemble_system
from .water import OPC, WATER_NUMBER_DENSITY

DEG = math.pi / 180.0

# ---- alanine residue template: atoms, charges (ff14SB ALA set), LJ ----
# (name, element, charge, rmin/2, eps, mass)
_ALA_ATOMS = [
    ("N",  "N", -0.4157, 1.8240, 0.1700, 14.007),
    ("H",  "H",  0.2719, 0.6000, 0.0157, 1.008),
    ("CA", "C",  0.0337, 1.9080, 0.1094, 12.011),
    ("HA", "H",  0.0823, 1.3870, 0.0157, 1.008),
    ("CB", "C", -0.1825, 1.9080, 0.1094, 12.011),
    ("HB1", "H", 0.0603, 1.4870, 0.0157, 1.008),
    ("HB2", "H", 0.0603, 1.4870, 0.0157, 1.008),
    ("HB3", "H", 0.0603, 1.4870, 0.0157, 1.008),
    ("C",  "C",  0.5973, 1.9080, 0.0860, 12.011),
    ("O",  "O", -0.5679, 1.6612, 0.2100, 15.999),
]
_RMIN_TO_SIGMA = 2.0 / 2.0 ** (1.0 / 6.0)

# intra-residue bonds (k kcal/mol/A^2, r0 A)
_ALA_BONDS = [
    ("N", "H", 434.0, 1.010), ("N", "CA", 337.0, 1.449),
    ("CA", "HA", 340.0, 1.092), ("CA", "CB", 310.0, 1.526),
    ("CB", "HB1", 340.0, 1.092), ("CB", "HB2", 340.0, 1.092),
    ("CB", "HB3", 340.0, 1.092), ("CA", "C", 317.0, 1.522),
    ("C", "O", 570.0, 1.229),
]
_PEPTIDE_BOND = ("C", "N", 490.0, 1.335)   # C(i) - N(i+1)

_ALA_ANGLES = [
    ("H", "N", "CA", 50.0, 118.0), ("N", "CA", "HA", 50.0, 109.5),
    ("N", "CA", "CB", 80.0, 109.7), ("N", "CA", "C", 63.0, 110.1),
    ("HA", "CA", "CB", 50.0, 109.5), ("HA", "CA", "C", 50.0, 109.5),
    ("CB", "CA", "C", 63.0, 111.1),
    ("CA", "CB", "HB1", 50.0, 109.5), ("CA", "CB", "HB2", 50.0, 109.5),
    ("CA", "CB", "HB3", 50.0, 109.5),
    ("HB1", "CB", "HB2", 35.0, 109.5), ("HB1", "CB", "HB3", 35.0, 109.5),
    ("HB2", "CB", "HB3", 35.0, 109.5),
    ("CA", "C", "O", 80.0, 120.4),
]
# inter-residue angles: (prev_atom, this/prev flags) handled in builder
_LINK_ANGLES = [
    ("C-", "N", "H", 50.0, 120.0), ("C-", "N", "CA", 50.0, 121.9),
    ("CA-", "C-", "N", 70.0, 116.6), ("O-", "C-", "N", 80.0, 122.9),
]
_ALA_DIHEDRALS = [
    # backbone phi/psi/omega-like generic terms + methyl rotor
    ("N", "CA", "C", "N+", 0.27, 2.0, 0.0),      # psi-ish (placeholder split)
    ("C-", "N", "CA", "C", 0.27, 2.0, 0.0),      # phi-ish
    ("CA-", "C-", "N", "CA", 2.50, 2.0, 180.0),  # omega (planar amide)
    ("O-", "C-", "N", "H", 2.00, 2.0, 180.0),    # amide improper-ish
    ("N", "CA", "CB", "HB1", 0.1556, 3.0, 0.0),
    ("N", "CA", "CB", "HB2", 0.1556, 3.0, 0.0),
    ("N", "CA", "CB", "HB3", 0.1556, 3.0, 0.0),
]


def _self_avoiding_walk(n_steps, step, box_half, min_sep, rng):
    """Compact self-avoiding random walk for the CA trace."""
    pts = [np.zeros(3)]
    d = np.array([1.0, 0.0, 0.0])
    for _ in range(n_steps - 1):
        for attempt in range(60):
            # propose a direction biased to keep going straight-ish
            prop = d + rng.normal(0, 0.8, 3)
            prop /= np.linalg.norm(prop)
            cand = pts[-1] + prop * step
            if np.abs(cand).max() > box_half:
                continue
            arr = np.asarray(pts[:-1]) if len(pts) > 1 else None
            if arr is not None and len(arr):
                if ((arr - cand) ** 2).sum(1).min() < min_sep ** 2:
                    continue
            break
        else:
            cand = pts[-1] + d * step  # give up on avoidance
            prop = d
        pts.append(cand)
        d = prop
    return np.asarray(pts)


def build_polyalanine(n_residues: int, compact_half_width: float = None,
                      seed: int = 0) -> MolSpec:
    """Connected poly-ALA chain on a compact self-avoiding CA trace.

    Half-width targets realistic protein density (~0.12 atoms/A^3, i.e.
    ~85 A^3 per 10-atom residue) — denser walks produce unphysical cores
    that also poison the cell-list capacity planning."""
    rng = np.random.default_rng(seed)
    half = compact_half_width or max(
        10.0, 0.62 * (n_residues * 85.0) ** (1 / 3) + 3.0)
    ca = _self_avoiding_walk(n_residues, 3.8, half, 5.3, rng)

    names = [a[0] for a in _ALA_ATOMS]
    idx_of = {n: i for i, n in enumerate(names)}
    nat = len(names)
    masses, charges, sig, eps, pos = [], [], [], [], []
    bonds, angles, dihedrals, hclusters = [], [], [], []

    def gidx(res, name):
        if name.endswith("-"):
            return (res - 1) * nat + idx_of[name[:-1]]
        if name.endswith("+"):
            return (res + 1) * nat + idx_of[name[:-1]]
        return res * nat + idx_of[name]

    for r in range(n_residues):
        d = (ca[min(r + 1, n_residues - 1)] - ca[max(r - 1, 0)])
        d = d / (np.linalg.norm(d) + 1e-9)
        # local frame
        up = np.array([0.0, 0.0, 1.0])
        if abs(d @ up) > 0.9:
            up = np.array([0.0, 1.0, 0.0])
        e1 = np.cross(d, up); e1 /= np.linalg.norm(e1)
        e2 = np.cross(d, e1)
        c = ca[r]
        local = {
            "N": c - 1.45 * d + 0.25 * e1,
            "H": c - 1.95 * d + 1.10 * e1,
            "CA": c,
            "HA": c + 0.95 * e2 + 0.45 * e1,
            "CB": c - 0.5 * d - 1.40 * e2,
            "HB1": c - 0.5 * d - 2.0 * e2 + 0.9 * e1,
            "HB2": c - 0.5 * d - 2.0 * e2 - 0.9 * e1,
            "HB3": c - 1.35 * d - 1.6 * e2,
            "C": c + 1.45 * d - 0.25 * e1,
            "O": c + 1.75 * d - 1.40 * e1,
        }
        for (nm, el, q, rm, ep, m) in _ALA_ATOMS:
            masses.append(m); charges.append(q)
            sig.append(rm * _RMIN_TO_SIGMA); eps.append(ep)
            pos.append(local[nm])
        for (a, b, k, r0) in _ALA_BONDS:
            bonds.append((gidx(r, a), gidx(r, b), k, r0))
        for (a, b, cth, k, t0) in _ALA_ANGLES:
            angles.append((gidx(r, a), gidx(r, b), gidx(r, cth), k, t0 * DEG))
        if r > 0:
            a, b, k, r0 = _PEPTIDE_BOND
            bonds.append((gidx(r - 1, a), gidx(r, b), k, r0))
            for (x, y, z, k2, t0) in _LINK_ANGLES:
                try:
                    angles.append((gidx(r, x), gidx(r, y), gidx(r, z),
                                   k2, t0 * DEG))
                except KeyError:
                    pass
        for (a, b, cc, dd, k, n, ph) in _ALA_DIHEDRALS:
            try:
                ia, ib = gidx(r, a), gidx(r, b)
                ic, idd = gidx(r, cc), gidx(r, dd)
            except (KeyError, IndexError):
                continue
            if max(ia, ib, ic, idd) >= n_residues * nat or min(ia, ib, ic, idd) < 0:
                continue
            dihedrals.append((ia, ib, ic, idd, k, n, ph * DEG))
        # H-constraint clusters
        hclusters.append((gidx(r, "N"), [gidx(r, "H")], [1.010]))
        hclusters.append((gidx(r, "CA"), [gidx(r, "HA")], [1.092]))
        hclusters.append((gidx(r, "CB"),
                          [gidx(r, "HB1"), gidx(r, "HB2"), gidx(r, "HB3")],
                          [1.092] * 3))

    # zwitterionic termini left neutral for simplicity (benchmark system)
    charges = np.asarray(charges)
    charges -= charges.sum() / len(charges)   # exactly neutral
    pos = np.asarray(pos)
    pos -= pos.mean(axis=0)
    return MolSpec(
        masses=np.asarray(masses), charges=charges,
        lj_sigma=np.asarray(sig), lj_eps=np.asarray(eps),
        positions=pos, bonds=bonds, angles=angles, dihedrals=dihedrals,
        hclusters=hclusters, ff_mol_type="peptide",
    )


def build_solvated_protein(n_residues: int = 250, box_side: float = None,
                           water_model=OPC, seed: int = 0,
                           target_sites: int = None):
    """Config 3: solvated polyalanine, ~25k atom sites by default."""
    prot = build_polyalanine(n_residues, seed=seed)
    if box_side is None:
        if target_sites is None:
            target_sites = 25000
        n_w = (target_sites - prot.n_atoms) // water_model.site_count
        # waters displaced by protein: solve box so free volume fits n_w
        prot_vol = prot.n_atoms * 18.0          # ~A^3 heuristic
        vol = n_w / WATER_NUMBER_DENSITY + prot_vol
        box_side = vol ** (1.0 / 3.0)
        # (the cluster backend has no box-granularity constraint; snap to a
        # multiple of ~9.35 A only if you want the Pallas window plan to be
        # admissible at a 9 A cutoff)
    box = np.array([box_side] * 3)
    prot = prot.translated(box / 2.0 - prot.positions.mean(axis=0))
    asys = assemble_system(
        [prot], box_extent=box, water_model=water_model,
        seed=seed, neutralize=False,
    )
    return asys
