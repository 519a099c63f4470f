"""MoleculeCommon: the shared host-side molecule container.

Copy of molchanica_tpu.molecules.common:
the same host code, so its results equal the reference's bit for bit.

Mirrors the reference's `MoleculeCommon` (src/molecules/common.rs:33: atoms,
bonds, adjacency, atom_posits as the mutable pose layer) in a numpy-friendly
form. IO readers produce it; typing/params consume it; `to_spec` bridges to
the simulation layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class MoleculeCommon:
    elements: List[str]
    positions: np.ndarray                 # [n, 3] A — the mutable pose layer
    bonds: List[Tuple[int, int]] = field(default_factory=list)
    bond_orders: Optional[List[float]] = None
    atom_names: Optional[List[str]] = None
    res_names: Optional[List[str]] = None
    res_ids: Optional[List[int]] = None
    chains: Optional[List[str]] = None
    charges: Optional[np.ndarray] = None  # partial charges if provided
    formal_charges: Optional[List[int]] = None
    name: str = ""
    hetero: Optional[List[bool]] = None

    @property
    def n_atoms(self) -> int:
        return len(self.elements)

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.n_atoms)]
        for i, j in self.bonds:
            adj[i].append(j)
            adj[j].append(i)
        return adj

    def centroid(self) -> np.ndarray:
        return np.asarray(self.positions).mean(axis=0)

    def translated(self, shift) -> "MoleculeCommon":
        import copy
        m = copy.copy(self)
        m.positions = np.asarray(self.positions) + np.asarray(shift)
        return m

    def rotated(self, rotmat, about=None) -> "MoleculeCommon":
        import copy
        m = copy.copy(self)
        c = self.centroid() if about is None else np.asarray(about)
        m.positions = (np.asarray(self.positions) - c) @ np.asarray(rotmat).T + c
        return m

    def infer_bonds(self):
        from .bond_inference import infer_bonds
        self.bonds = infer_bonds(self.elements, self.positions)
        self.bond_orders = None
        return self

    def to_spec(self, params=None, charges=None, ff_mol_type="small_organic",
                strict=False):
        """Type + parameterize into a simulation-ready MolSpec."""
        from ..ff.charges import gasteiger_charges
        from ..ff.params import FfParamSet, assign_params
        from ..ff.typing_gaff import assign_gaff_types

        if params is None:
            params = FfParamSet.new_default().small_mol
        types = assign_gaff_types(self.elements, self.bonds, self.bond_orders)
        if charges is None:
            charges = self.charges
        if charges is None:
            charges = gasteiger_charges(
                self.elements, self.bonds, self.bond_orders,
                self.formal_charges)
        return assign_params(
            self.elements, types, charges, self.positions, self.bonds,
            params, ff_mol_type=ff_mol_type, strict=strict)
