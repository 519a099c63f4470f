"""MolSpec: a fully-parameterized molecule ready for simulation, and the
assembler that concatenates solutes + solvent into one fixed-shape Topology
(copy of molchanica_tpu.molecules.spec; the Topology holds torch tensors).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..systems.water import WaterModel, fill_water_positions
from ..topology import Topology, make_topology

# Reference FfMolType (src/md/mod.rs:1044-1071)
FF_MOL_TYPES = ("peptide", "small_organic", "dna", "rna", "lipid", "water",
                "ion")


@dataclass
class MolSpec:
    """One parameterized molecule (host-side, numpy)."""
    masses: np.ndarray
    charges: np.ndarray
    lj_sigma: np.ndarray
    lj_eps: np.ndarray
    positions: np.ndarray                       # [n, 3] A
    bonds: list = field(default_factory=list)   # (i, j, k, r0)
    angles: list = field(default_factory=list)  # (i, j, k, kth, th0)
    dihedrals: list = field(default_factory=list)  # (i,j,k,l,kphi,n,phase)
    pairs14: Optional[list] = None
    exclusions: Optional[list] = None
    hclusters: list = field(default_factory=list)  # (heavy,[h..],[r0..])
    ff_mol_type: str = "small_organic"
    static_: bool = False                        # frozen atoms (docking)
    bonded_only: bool = False
    velocities: Optional[np.ndarray] = None

    @property
    def n_atoms(self) -> int:
        return len(self.masses)

    def translated(self, shift) -> "MolSpec":
        import copy
        m = copy.copy(self)
        m.positions = self.positions + np.asarray(shift)
        return m


@dataclass
class AssembledSystem:
    topology: Topology
    positions: np.ndarray        # [N, 3]
    box_extent: Optional[np.ndarray]
    mol_start_indices: List[int]  # per-molecule first-atom index
                                  # (solutes first, then waters)
    n_solute_atoms: int
    water_model: Optional[WaterModel]
    n_waters: int


def assemble_system(
    mols: Sequence[MolSpec],
    box_extent=None,
    water_model: Optional[WaterModel] = None,
    n_waters: Optional[int] = None,
    alchemical_mol: Optional[int] = None,
    constrain_h: bool = True,
    pad_atoms_to_multiple: int = 256,
    seed: int = 0,
    neutralize: bool = False,
    relieve_clashes: bool = True,
    clash_distance: float = 1.9,
    water_region=None,
) -> AssembledSystem:
    """Concatenate molecules (+ optional water fill) into one Topology.

    Waters go after all solute molecules as contiguous (O,H1,H2[,M]) blocks.
    The Topology's tensors live on the CPU; engines move them.
    """
    masses, charges, sig, eps, pos = [], [], [], [], []
    bonds, angles, dihedrals, pairs14, excl, hcl = [], [], [], [], [], []
    mol_id, mol_starts, dof = [], [], []
    couple = []
    off = 0
    for mi, m in enumerate(mols):
        n = m.n_atoms
        mol_starts.append(off)
        masses.append(np.asarray(m.masses, np.float64))
        charges.append(np.asarray(m.charges, np.float64))
        sig.append(np.asarray(m.lj_sigma, np.float64))
        eps.append(np.asarray(m.lj_eps, np.float64))
        pos.append(np.asarray(m.positions, np.float64))
        bonds += [(i + off, j + off, k, r) for i, j, k, r in m.bonds]
        angles += [(a + off, b + off, c + off, k, t)
                   for a, b, c, k, t in m.angles]
        dihedrals += [(a + off, b + off, c + off, d + off, k, nn, p)
                      for a, b, c, d, k, nn, p in m.dihedrals]
        if m.pairs14 is not None:
            pairs14 += [tuple(v + off for v in p[:2]) + tuple(p[2:])
                        for p in m.pairs14]
        if m.exclusions is not None:
            excl += [(i + off, j + off) for i, j in m.exclusions]
        if constrain_h:
            hcl += [(h + off, [x + off for x in hs], r0s)
                    for h, hs, r0s in m.hclusters]
        mol_id += [mi] * n
        dof += [0.0 if m.static_ else 1.0] * n
        couple += [1.0 if alchemical_mol == mi else 0.0] * n
        off += n

    n_solute = off
    use_explicit_p14 = any(m.pairs14 is not None for m in mols)
    use_explicit_excl = any(m.exclusions is not None for m in mols)

    # ---- water block ----
    n_w = 0
    vsites = []
    water_start = off
    if water_model is not None:
        assert box_extent is not None, "water fill requires a box"
        wpos = fill_water_positions(
            box_extent, exclude_positions=np.concatenate(pos) if pos else None,
            model=water_model, n_target=n_waters, seed=seed,
            region=water_region)
        n_w = len(wpos)
        sc = water_model.site_count
        wm = water_model
        for w in range(n_w):
            o = off + w * sc
            masses.append(np.asarray(wm.masses, np.float64))
            charges.append(np.asarray(wm.charges, np.float64))
            s_lj = [wm.sigma_o, wm.sigma_h, wm.sigma_h]
            e_lj = [wm.eps_o, wm.eps_h, wm.eps_h]
            if sc == 4:
                s_lj.append(1.0)
                e_lj.append(0.0)
            sig.append(np.asarray(s_lj)); eps.append(np.asarray(e_lj))
            pos.append(wpos[w])
            # rigid water: no bonded terms, full intra-molecular exclusion
            pairs = [(o, o + 1), (o, o + 2), (o + 1, o + 2)]
            if sc == 4:
                pairs += [(o, o + 3), (o + 1, o + 3), (o + 2, o + 3)]
                vsites.append((o + 3, o, o + 1, o + 2, wm.vsite_weight))
            excl += pairs
            mol_id += [len(mols) + w] * sc
            dof += [1.0, 1.0, 1.0] + ([0.0] if sc == 4 else [])
            couple += [0.0] * sc
            mol_starts.append(o)
        use_explicit_excl = True
        # waters added exclusions explicitly; solutes may rely on derivation
        if not use_explicit_p14:
            pass

    if use_explicit_excl and not all(m.exclusions is not None for m in mols):
        # derive solute exclusions from bonds/angles and merge
        derived = set()
        for b in bonds:
            derived.add((min(b[0], b[1]), max(b[0], b[1])))
        for a in angles:
            derived.add((min(a[0], a[2]), max(a[0], a[2])))
        excl = sorted(set(excl) | derived)

    masses = np.concatenate(masses) if masses else np.zeros(0)
    charges = np.concatenate(charges)
    sig = np.concatenate(sig)
    eps = np.concatenate(eps)
    positions = np.concatenate(pos)
    n_real = len(masses)

    if relieve_clashes and n_real:
        from ..systems.overlap_relief import relieve_overlaps
        if use_explicit_excl:
            excl_set = set(excl)
        else:
            excl_set = {(min(b[0], b[1]), max(b[0], b[1])) for b in bonds}
            excl_set |= {(min(a[0], a[2]), max(a[0], a[2])) for a in angles}
        # waters are rigid groups (their internal geometry must survive)
        rigid = np.full(n_real, -1, np.int64)
        if n_w > 0:
            sc = water_model.site_count
            for w in range(n_w):
                rigid[water_start + w * sc: water_start + (w + 1) * sc] = w
        positions = relieve_overlaps(
            positions, None if box_extent is None else np.asarray(box_extent),
            excl_set, d_min=clash_distance, rigid_group_id=rigid)

    if neutralize:
        qtot = charges.sum()
        # distribute tiny counter-charge over solvent oxygens (placeholder
        # for explicit counter-ions; see systems/ions.py)
        if abs(qtot) > 1e-6 and n_w > 0:
            sc = water_model.site_count
            o_idx = water_start + np.arange(n_w) * sc
            charges[o_idx] -= qtot / n_w

    pad_to = int(math.ceil(n_real / pad_atoms_to_multiple)
                 ) * pad_atoms_to_multiple

    top = make_topology(
        masses, charges, sig, eps,
        bonds=bonds, angles=angles, dihedrals=dihedrals,
        pairs14=pairs14 if use_explicit_p14 else None,
        exclusions=excl if use_explicit_excl else None,
        mol_id=np.asarray(mol_id, np.int32),
        couple_mask=np.asarray(couple),
        pad_atoms_to=pad_to,
        water_start=water_start,
        water_count=n_w,
        water_site_count=water_model.site_count if water_model else 0,
        water_geometry=(
            (water_model.r_oh, water_model.theta_hoh, water_model.r_om)
            if water_model else (0.0, 0.0, 0.0)),
        hclusters=hcl,
        dof_mask=np.asarray(dof),
        vsites=vsites,
    )
    x0 = np.zeros((pad_to, 3))
    x0[:n_real] = positions
    # park padding atoms far outside the box on a spread-out line so they
    # can't collide with each other in cell binning (mask keeps them inert)
    x0[n_real:] = 1e6
    return AssembledSystem(
        topology=top, positions=x0,
        box_extent=None if box_extent is None else np.asarray(box_extent),
        mol_start_indices=mol_starts, n_solute_atoms=n_solute,
        water_model=water_model, n_waters=n_w,
    )
