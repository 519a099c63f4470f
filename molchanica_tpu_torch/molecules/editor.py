"""Molecule editor with live MD: atom/bond add-delete while a simulation
keeps relaxing the structure between edits.

Copy of molchanica_tpu.molecules.editor, but for the device: the
live MD is the port's MdSim on `device` (None: the CUDA card).

Headless counterpart of the reference's 3D small-molecule editor
(src/mol_editor/mod.rs — own `md_step` loop at :347,
position sync-back at :330-344, atom/bond editing in add_atoms.rs): each
edit mutates the molecule, rebuilds the MD system (topology changes can't
be traced through), restarts a vacuum sim from the current positions, and
`md_step()` advances it and syncs positions back into the molecule —
exactly the reference's edit-while-simulating workflow, minus the mouse.

Hydrogen placement uses the same geometry builders the reference pulls
from the dynamics crate (find_tetra_posits / find_planar_posits — SURVEY
§2.1 geometry builders).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .common import MoleculeCommon
from .elements import COVALENT_RADII
from .geometry import find_planar_posits, find_tetra_posits


class MolEditor:
    """Edit a molecule with a live vacuum MD relaxing it between edits.

    The MD runs on `device` (None: the CUDA card; tests pass "cpu")."""

    def __init__(self, mol: Optional[MoleculeCommon] = None,
                 dt_ps: float = 0.0005, steps_per_tick: int = 10,
                 temp_target: float = 150.0, device=None):
        self.mol = mol or MoleculeCommon(elements=[], positions=np.zeros(
            (0, 3)))
        self.dt_ps = dt_ps
        self.steps_per_tick = steps_per_tick
        self.temp_target = temp_target
        self.device = device
        self._sim = None
        self.running = False

    # -- editing ---------------------------------------------------------
    def add_atom(self, element: str, bond_to: Optional[int] = None,
                 geometry: str = "tetrahedral") -> int:
        """Add an atom; when bonded, place it with the tetra/planar
        builders using the neighbor's existing bonds as 'known' directions
        (mol_editor/add_atoms.rs workflow)."""
        m = self.mol
        pos = np.asarray(m.positions, np.float64).reshape(-1, 3)
        if bond_to is None:
            p = pos.mean(axis=0) + [2.0, 0.0, 0.0] if len(pos) else \
                np.zeros(3)
        else:
            center = pos[bond_to]
            known = [pos[j] for j in m.adjacency()[bond_to]]
            blen = (COVALENT_RADII.get(m.elements[bond_to], 0.77)
                    + COVALENT_RADII.get(element, 0.77))
            if geometry == "planar":
                cands = find_planar_posits(center, known, blen)
            else:
                cands = find_tetra_posits(center, known, blen)
            if len(cands):
                p = np.asarray(cands[0])
            else:
                # saturated center: place opposite the neighbor average
                # (the editor never refuses an edit; chemistry is the
                # user's business — matching the reference's free editing)
                away = center - np.mean(known, axis=0) if known else \
                    np.array([1.0, 0.0, 0.0])
                n = np.linalg.norm(away)
                away = away / n if n > 1e-9 else np.array([1.0, 0.0, 0.0])
                p = center + blen * away
        new_idx = m.n_atoms
        m.elements.append(element)
        m.positions = np.concatenate([pos, p[None, :]], axis=0)
        if bond_to is not None:
            m.bonds.append((bond_to, new_idx))
        self._invalidate()
        return new_idx

    def delete_atom(self, idx: int):
        """Remove an atom and its bonds; remaining indices shift down."""
        m = self.mol
        m.elements.pop(idx)
        m.positions = np.delete(np.asarray(m.positions), idx, axis=0)
        new_bonds = []
        for i, j in m.bonds:
            if i == idx or j == idx:
                continue
            new_bonds.append((i - (i > idx), j - (j > idx)))
        m.bonds = new_bonds
        self._invalidate()

    def add_bond(self, i: int, j: int):
        if (i, j) not in self.mol.bonds and (j, i) not in self.mol.bonds:
            self.mol.bonds.append((min(i, j), max(i, j)))
            self._invalidate()

    def delete_bond(self, i: int, j: int):
        self.mol.bonds = [b for b in self.mol.bonds
                          if set(b) != {i, j}]
        self._invalidate()

    def add_hydrogens(self, idx: int, count: int = 1,
                      geometry: str = "tetrahedral"):
        for _ in range(count):
            self.add_atom("H", bond_to=idx, geometry=geometry)

    # -- live MD ---------------------------------------------------------
    def _invalidate(self):
        self._sim = None       # topology changed; rebuild lazily

    def _build_sim(self):
        from ..md.config import HydrogenConstraint, Integrator, MdConfig
        from ..md.engine import MdSim
        from .spec import assemble_system

        spec = self.mol.to_spec(strict=False)
        asys = assemble_system([spec])
        cfg = MdConfig(
            integrator=Integrator.langevin_middle(gamma=5.0),
            temp_target=self.temp_target,
            hydrogen_constraint=HydrogenConstraint.flexible(),
            dtype="float32", max_init_relaxation_iters=50, seed=11)
        self._sim = MdSim(asys.topology, cfg, asys.positions,
                          device=self.device)
        self._n_real = self.mol.n_atoms

    def start(self):
        self.running = True

    def stop(self):
        self.running = False

    def md_step(self):
        """Advance the live MD one tick and sync positions back into the
        molecule (mol_editor/mod.rs:330-347 load_atom_posits_from_md)."""
        if not self.running or self.mol.n_atoms < 2:
            return
        if self._sim is None:
            self._build_sim()
        self._sim.step(self.dt_ps, self.steps_per_tick)
        x = self._sim.state.positions[:self._n_real]
        self.mol.positions = x.detach().cpu().numpy().copy()
