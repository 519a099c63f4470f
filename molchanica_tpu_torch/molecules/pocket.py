"""Binding-pocket molecule type (reference src/molecules/pocket.rs).

Copy of molchanica_tpu.molecules.pocket:
the same host code, so its results equal the reference's bit for bit.

A pocket is the receptor neighborhood of a binding site: the protein atoms
(usually whole residues) within a cutoff of a bound ligand or site center.
PDBbind ships one per complex as `<id>_pocket.pdb`; this type also cuts
pockets out of full structures for docking setups (docking/setup.py takes
`site_center`/`site_radius` — a pocket provides exactly that receptor
subset plus provenance).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .common import MoleculeCommon


@dataclass
class MoleculePocket:
    """Receptor-site subset with its origin and geometry."""
    mol: MoleculeCommon
    center: np.ndarray                      # site center [3]
    radius: float                           # covering radius (A)
    source_pdb_id: Optional[str] = None
    parent_atom_idx: Optional[np.ndarray] = None   # indices into the parent

    @property
    def n_atoms(self) -> int:
        return self.mol.n_atoms

    @classmethod
    def from_file(cls, path, pdb_id: Optional[str] = None,
                  ligand: Optional[MoleculeCommon] = None):
        """Load a pre-cut pocket file (e.g. PDBbind `*_pocket.pdb`)."""
        from ..io.pdb import read_pdb
        mol = read_pdb(path)
        pos = np.asarray(mol.positions)
        if ligand is not None:
            center = np.asarray(ligand.positions).mean(axis=0)
        else:
            center = pos.mean(axis=0)
        radius = float(np.linalg.norm(pos - center, axis=1).max())
        return cls(mol=mol, center=center, radius=radius,
                   source_pdb_id=pdb_id)

    @classmethod
    def cut(cls, protein: MoleculeCommon, center, radius: float = 10.0,
            whole_residues: bool = True, pdb_id: Optional[str] = None):
        """Cut a pocket out of a full structure: atoms within `radius` of
        `center`; with whole_residues, any touched residue is kept whole
        (matching how PDBbind pockets are cut)."""
        pos = np.asarray(protein.positions)
        center = np.asarray(center, np.float64)
        near = np.linalg.norm(pos - center, axis=1) <= radius
        res_ids = getattr(protein, "residue_ids", None)
        if whole_residues and res_ids is not None:
            res_ids = np.asarray(res_ids)
            keep_res = set(res_ids[near].tolist())
            near = np.isin(res_ids, list(keep_res))
        idx = np.where(near)[0]
        remap = {int(a): k for k, a in enumerate(idx)}
        sub = MoleculeCommon(
            elements=[protein.elements[i] for i in idx],
            positions=pos[idx].copy(),
            bonds=[(remap[i], remap[j]) for i, j in protein.bonds
                   if i in remap and j in remap])
        return cls(mol=sub, center=center, radius=float(radius),
                   source_pdb_id=pdb_id, parent_atom_idx=idx)

    def docking_site(self) -> Tuple[np.ndarray, float]:
        """(site_center, site_radius) for docking/setup.py DockingSetup."""
        return self.center, self.radius
