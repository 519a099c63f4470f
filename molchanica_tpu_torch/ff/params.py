"""FfParamSet: per-molecule-class parameter sets + assignment to molecules.

Copy of molchanica_tpu.ff.params:
the same host code, so its results equal the reference's bit for bit.

Reference surface: `FfParamSet` with fields {peptide, small_mol, lipids, dna,
rna} (src/gromacs/mod.rs:68-96), `merge_params`, `assign_missing_params`
(SURVEY.md §2.1). Assignment turns (atoms with ff types + bonds) into a
fully-parameterized MolSpec ready for `assemble_system`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..molecules.spec import MolSpec
from .amber_dat import ForceFieldParams, RMIN2_TO_SIGMA

DEG = math.pi / 180.0


@dataclass
class FfParamSet:
    """Per-class parameter sets (reference field names preserved)."""
    peptide: Optional[ForceFieldParams] = None
    small_mol: Optional[ForceFieldParams] = None   # GAFF2
    lipids: Optional[ForceFieldParams] = None
    dna: Optional[ForceFieldParams] = None
    rna: Optional[ForceFieldParams] = None

    def for_mol_type(self, ff_mol_type: str) -> Optional[ForceFieldParams]:
        return {
            "peptide": self.peptide,
            "small_organic": self.small_mol,
            "lipid": self.lipids,
            "dna": self.dna,
            "rna": self.rna,
        }.get(ff_mol_type)

    @staticmethod
    def new_default() -> "FfParamSet":
        """Built-in approximate GAFF2-subset so small organics simulate out
        of the box; load real .dat files for production parameters
        (reference: FfParamSet::new_amber, src/main.rs:169)."""
        from .data.gaff2_subset import GAFF2_SUBSET
        return FfParamSet(small_mol=GAFF2_SUBSET, peptide=GAFF2_SUBSET)


def merge_params(base: ForceFieldParams,
                 patch: ForceFieldParams) -> ForceFieldParams:
    """Overlay `patch` (e.g. an frcmod) onto `base`; patch wins conflicts.
    (reference: merge_params, SURVEY §2.1)"""
    out = ForceFieldParams(title=base.title)
    for attr in ("masses", "bonds", "angles", "dihedrals", "impropers",
                 "nonbonded", "equivalences"):
        d = dict(getattr(base, attr))
        d.update(getattr(patch, attr))
        setattr(out, attr, d)
    return out


class MissingParameter(KeyError):
    """Raised when a required parameter has no entry (reference ParamError)."""


def _angles_from_bonds(n_atoms, bonds):
    adj = [[] for _ in range(n_atoms)]
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    angles = []
    for j in range(n_atoms):
        nb = adj[j]
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                angles.append((nb[a], j, nb[b]))
    return angles, adj


def _dihedrals_from_bonds(bonds, adj):
    dihedrals = []
    for j, k in bonds:
        for i in adj[j]:
            if i == k:
                continue
            for l in adj[k]:
                if l == j or l == i:
                    continue
                dihedrals.append((i, j, k, l))
    return dihedrals


def _impropers_from_adj(adj, types, params):
    """Candidate improper centers: atoms with exactly 3 neighbors."""
    rows = []
    for c, nb in enumerate(adj):
        if len(nb) != 3:
            continue
        i, j, k = nb
        terms = _folded(params.improper,
                        types[i], types[j], types[c], types[k])
        if terms:
            rows.append(((i, j, c, k), terms))
    return rows


def _folded(lookup, *ts):
    """Parameter lookup with the GAFF conjugation-split fold: exact types
    first, then each split replaced by its parametrized parent class
    (typing_gaff.GAFF_PARENT — cc/cd->ca, ce/cf->c2, nb/nc/nd->n2, ...).
    Keeps full-fidelity TYPING (the reference's find_ff_types surface)
    working against the embedded parameter subset; a real gaff2.dat loaded
    via parse_dat hits the exact entries and never folds."""
    p = lookup(*ts)
    if p is None:
        from .typing_gaff import fold_type
        fts = tuple(fold_type(t) for t in ts)
        if fts != ts:
            p = lookup(*fts)
    return p


def assign_params(
    elements: Sequence[str],
    types: Sequence[str],
    charges: Sequence[float],
    positions: np.ndarray,
    bonds: Sequence[Tuple[int, int]],
    params: ForceFieldParams,
    ff_mol_type: str = "small_organic",
    strict: bool = True,
    scee: float = 1.2,
    scnb: float = 2.0,
) -> MolSpec:
    """Build a fully-parameterized MolSpec from typed atoms + connectivity.

    This is the per-molecule core of the reference's parameter assignment
    inside MdState::new (assign_missing_params / find_ff_types consumers).
    """
    n = len(types)
    masses, sig, eps = [], [], []
    missing: List[str] = []
    from ..molecules.elements import element_mass

    from .typing_gaff import fold_type
    for t, el in zip(types, elements):
        m = params.masses.get(t)
        if m is None:
            m = params.masses.get(fold_type(t))
        masses.append(m if m is not None else element_mass(el))
        se = _folded(params.lj_sigma_eps, t)
        if se is None:
            missing.append(f"nonbonded {t}")
            se = (3.0, 0.1)
        sig.append(se[0])
        eps.append(se[1])

    bond_rows = []
    hclusters: Dict[int, Tuple[List[int], List[float]]] = {}
    for i, j in bonds:
        p = _folded(params.bond, types[i], types[j])
        if p is None:
            missing.append(f"bond {types[i]}-{types[j]}")
            p = (300.0, float(np.linalg.norm(positions[i] - positions[j])))
        bond_rows.append((i, j, p[0], p[1]))
        # H clusters for constraints
        hi, hj = elements[i] == "H", elements[j] == "H"
        if hi != hj:
            heavy, h = (j, i) if hi else (i, j)
            hclusters.setdefault(heavy, ([], []))
            hclusters[heavy][0].append(h)
            hclusters[heavy][1].append(p[1])

    angle_idx, adj = _angles_from_bonds(n, bonds)
    angle_rows = []
    for i, j, k in angle_idx:
        p = _folded(params.angle, types[i], types[j], types[k])
        if p is None:
            missing.append(f"angle {types[i]}-{types[j]}-{types[k]}")
            p = (50.0, 109.5 * DEG)
        angle_rows.append((i, j, k, p[0], p[1]))

    dihedral_rows = []
    pairs14 = set()
    excl = set()
    for i, j in bonds:
        excl.add((min(i, j), max(i, j)))
    for i, j, k in angle_idx:
        excl.add((min(i, k), max(i, k)))
    for i, j, k, l in _dihedrals_from_bonds(bonds, adj):
        if i > l:   # canonical direction to avoid double counting
            continue
        terms = _folded(params.dihedral,
                        types[i], types[j], types[k], types[l])
        if terms is None:
            missing.append(
                f"dihedral {types[i]}-{types[j]}-{types[k]}-{types[l]}")
            terms = []
        for t in terms:
            if t.k != 0.0:
                dihedral_rows.append((i, j, k, l, t.k, t.periodicity, t.phase))
        key = (min(i, l), max(i, l))
        if key not in excl:
            pairs14.add(key)
    for (idx4, terms) in _impropers_from_adj(adj, list(types), params):
        for t in terms:
            dihedral_rows.append(
                (idx4[0], idx4[1], idx4[2], idx4[3], t.k, t.periodicity,
                 t.phase))

    if strict and missing:
        raise MissingParameter(
            f"{len(missing)} missing parameters, first: {missing[:5]}")

    return MolSpec(
        masses=np.asarray(masses, np.float64),
        charges=np.asarray(charges, np.float64),
        lj_sigma=np.asarray(sig, np.float64),
        lj_eps=np.asarray(eps, np.float64),
        positions=np.asarray(positions, np.float64),
        bonds=bond_rows,
        angles=angle_rows,
        dihedrals=dihedral_rows,
        pairs14=[(i, j, scee, scnb) for i, j in sorted(pairs14)],
        exclusions=sorted(excl),
        hclusters=[(heavy, hs, r0s)
                   for heavy, (hs, r0s) in sorted(hclusters.items())],
        ff_mol_type=ff_mol_type,
    )
