"""Procedural inorganic crystal lattices: graphite, diamond, rock salt.

Copy of molchanica_tpu.molecules.crystal_lattice:
the same host code, so its results equal the reference's bit for bit.

TPU-framework counterpart of the reference's crystal experiments
(src/crystal.rs:1-60,453): build periodically tiled
supercells of non-organic crystals as MoleculeCommon objects, with
cutoff-based bond inference inside the stored cell (periodic-image bonds are
not represented, matching the reference's AtomInCrystal.adjacent contract).

Lattice constants are room-temperature values (crystal.rs:28-33). Bonds use
a covalent-radius criterion scaled by CRYSTAL_BOND_RADIUS_SCALE = 1.18
(crystal.rs:24) so graphite's 1.42 A in-plane bonds connect while its 3.35 A
inter-layer contacts do not.

For MD these lattices pair with ionic parameter sets (Joung-Cheatham for
NaCl) or fall outside fixed-topology force fields entirely (extended
covalent networks) — see crystal.rs:7-11; here they serve geometry,
visualization, density and lattice-energy workloads.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from .common import MoleculeCommon

GRAPHITE_LATTICE_A = 2.461
GRAPHITE_LATTICE_C = 6.708
DIAMOND_LATTICE_A = 3.567
SODIUM_CHLORIDE_LATTICE_A = 5.640
CRYSTAL_BOND_RADIUS_SCALE = 1.18

_COV_RADII = {"C": 0.76, "Na": 1.66, "Cl": 1.02}


def _tile(cell_vecs: np.ndarray, frac_sites, elements, reps) -> Tuple[
        np.ndarray, list]:
    """Tile fractional basis sites over an (na, nb, nc) supercell."""
    na, nb, nc = reps
    frac = np.asarray(frac_sites, np.float64)
    pos = []
    elems = []
    for ia in range(na):
        for ib in range(nb):
            for ic in range(nc):
                shift = np.array([ia, ib, ic], np.float64)
                cart = (frac + shift) @ cell_vecs
                pos.append(cart)
                elems.extend(elements)
    return np.concatenate(pos, axis=0), elems


def _bond_by_cutoff(elements, positions) -> list:
    """In-cell bonds: |r_ij| <= scale * (r_cov_i + r_cov_j). O(n^2) numpy —
    lattices here are small construction-time objects."""
    pos = np.asarray(positions)
    r = np.array([_COV_RADII.get(e, 0.77) for e in elements])
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    cut = CRYSTAL_BOND_RADIUS_SCALE * (r[:, None] + r[None, :])
    i, j = np.where((d <= cut) & (d > 1e-6))
    return [(int(a), int(b)) for a, b in zip(i, j) if a < b]


def build_graphite(reps=(3, 3, 2)) -> MoleculeCommon:
    """ABA (Bernal) graphite: hexagonal cell, 4-atom basis
    (crystal.rs GRAPHITE_LATTICE_A/C)."""
    a, c = GRAPHITE_LATTICE_A, GRAPHITE_LATTICE_C
    cell = np.array([[a, 0.0, 0.0],
                     [-0.5 * a, a * math.sqrt(3) / 2.0, 0.0],
                     [0.0, 0.0, c]])
    basis = [(0.0, 0.0, 0.25), (1 / 3, 2 / 3, 0.25),
             (0.0, 0.0, 0.75), (2 / 3, 1 / 3, 0.75)]
    pos, elems = _tile(cell, basis, ["C"] * 4, reps)
    m = MoleculeCommon(elements=elems, positions=pos)
    m.bonds = _bond_by_cutoff(elems, pos)
    m.lattice_vectors = cell * np.asarray(reps)[:, None]
    return m


def build_diamond(reps=(2, 2, 2)) -> MoleculeCommon:
    """Diamond cubic: fcc + (1/4,1/4,1/4) basis, 8 atoms/cell
    (crystal.rs DIAMOND_LATTICE_A)."""
    a = DIAMOND_LATTICE_A
    cell = np.eye(3) * a
    fcc = [(0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)]
    basis = [s for s in fcc] + [tuple(np.add(s, 0.25) % 1.0) for s in fcc]
    pos, elems = _tile(cell, basis, ["C"] * 8, reps)
    m = MoleculeCommon(elements=elems, positions=pos)
    m.bonds = _bond_by_cutoff(elems, pos)
    m.lattice_vectors = cell * np.asarray(reps)[:, None]
    return m


def build_nacl(reps=(2, 2, 2)) -> MoleculeCommon:
    """Rock salt: two interpenetrating fcc lattices
    (crystal.rs SODIUM_CHLORIDE_LATTICE_A). No bonds — ionic crystal; MD
    uses Joung-Cheatham-style ion parameters (crystal.rs:8)."""
    a = SODIUM_CHLORIDE_LATTICE_A
    cell = np.eye(3) * a
    fcc = [(0, 0, 0), (0, 0.5, 0.5), (0.5, 0, 0.5), (0.5, 0.5, 0)]
    basis = fcc + [tuple((np.add(s, (0.5, 0, 0))) % 1.0) for s in fcc]
    elements = ["Na"] * 4 + ["Cl"] * 4
    pos, elems = _tile(cell, basis, elements, reps)
    m = MoleculeCommon(elements=elems, positions=pos)
    m.bonds = []
    m.lattice_vectors = cell * np.asarray(reps)[:, None]
    return m
