"""Conformer generation: torsion sampling + batched vacuum energy ranking
(port of molchanica_tpu.molecules.conformers).

Reference: src/molecules/conformers.rs (conformer sampling/representation,
summary features for ML). The torsion sampling is the reference's numpy
code, so the candidate coordinates are its bits. The candidates' vacuum
energies are one batched allpairs energy over the [C, N, 3] conformers on
the device (torch.func.vmap of md/energy.py's allpairs energy), and the
optional FIRE on the best one runs md/minimize.py with an autograd force.

The work is split where a molecule can fail on the host:
`prepare_conformers` (typing, system assembly, torsion sampling) and
`rank_conformers` (the device energies and FIRE). `generate_conformers`
runs both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..docking.poses import apply_torsion
from ..md.config import MdConfig
from ..md.energy import make_energy_fn, make_force_fn
from ..md.minimize import fire_minimize
from .characterization import find_rings, find_rotatable_bonds
from .common import MoleculeCommon
from .spec import assemble_system

# padded rows sit here, far from every real atom (the reference's fill)
PAD_POSITION = 1e6
# the energy terms whose magnitudes bound an energy's float32 roundoff
TERM_KEYS = ("bond", "angle", "dihedral", "lj", "coulomb")


@dataclass
class ConformerSet:
    coords: np.ndarray            # [K, n, 3] sorted by energy
    energies: np.ndarray          # [K] kcal/mol (vacuum)
    torsions: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def best(self) -> np.ndarray:
        return self.coords[0]

    def boltzmann_weights(self, temp_k: float = 298.15) -> np.ndarray:
        """Ensemble weights w_k ∝ exp(-ΔE_k / kT)."""
        kt = 0.0019872041 * temp_k             # kcal/mol
        e = self.energies - self.energies.min()
        w = np.exp(-e / kt)
        return w / w.sum()

    def radii_of_gyration(self) -> np.ndarray:
        com = self.coords.mean(axis=1, keepdims=True)
        return np.sqrt(((self.coords - com) ** 2).sum(-1).mean(-1))

    def deduplicate(self, rmsd_threshold: float = 0.5) -> "ConformerSet":
        """Greedy energy-ordered RMSD dedup (Kabsch-aligned): keep each
        conformer only if no kept lower-energy conformer is within the
        threshold. The reference stores a representative conformer set,
        not every raw torsion sample."""
        from .alignment import kabsch_rmsd

        keep: List[int] = []
        for k in range(len(self.coords)):
            if all(kabsch_rmsd(self.coords[k], self.coords[j])
                   > rmsd_threshold for j in keep):
                keep.append(k)
        return ConformerSet(coords=self.coords[keep],
                            energies=self.energies[keep],
                            torsions=self.torsions)

    def summary_features(self, temp_k: float = 298.15) -> np.ndarray:
        """Conformer-ensemble ML features (energy spread, radius-of-
        gyration stats, Boltzmann-averaged size + ensemble entropy —
        reference conformers.rs feature role)."""
        rg = self.radii_of_gyration()
        e = self.energies - self.energies.min()
        w = self.boltzmann_weights(temp_k)
        rg_boltz = float((w * rg).sum())
        # ensemble "flexibility entropy" -sum w ln w, normalized
        ent = float(-(w * np.log(np.maximum(w, 1e-30))).sum()
                    / max(np.log(max(len(w), 2)), 1e-9))
        return np.asarray([
            len(self.coords), float(e.mean()), float(e.std()),
            float(rg[0]), float(rg.mean()), float(rg.std()),
            rg_boltz, ent,
        ], np.float32)


def _moving_side(n, bonds, bond):
    """Atoms on the j-side of bond (i, j) (the set rotated by the torsion)."""
    i, j = bond
    adj = [[] for _ in range(n)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    seen = {i, j}
    stack = [j]
    out = []
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                out.append(v)
                stack.append(v)
    return out


@dataclass
class ConformerInputs:
    """The host side of one molecule's conformer search: the float32
    candidates [C, n, 3], the rotatable bonds, the vacuum topology (padded,
    on the CPU) and the energy config."""
    coords: np.ndarray
    torsions: List[Tuple[int, int]]
    topology: object
    cfg: MdConfig

    @property
    def n_atoms(self) -> int:
        return self.coords.shape[1]


def prepare_conformers(mol: MoleculeCommon, n_conformers: int = 32,
                       angles_per_torsion: int = 3, seed: int = 0,
                       params=None) -> ConformerInputs:
    """Torsion sampling (the reference's numpy code and generator order),
    then typing and assembly of the vacuum system. Raises where the
    molecule cannot be typed; touches no device."""
    n = mol.n_atoms
    adj = mol.adjacency()
    rings = find_rings(n, mol.bonds)
    torsions = find_rotatable_bonds(mol.elements, mol.bonds,
                                    mol.bond_orders, rings, adj)
    rng = np.random.default_rng(seed)
    base = np.asarray(mol.positions, float)
    cands = [base]
    if torsions:
        for _ in range(max(n_conformers - 1, 0)):
            c = base.copy()
            for bond in torsions:
                k = rng.integers(0, angles_per_torsion)
                ang = 2 * np.pi * k / angles_per_torsion \
                    + rng.normal(0, 0.15)
                moving = _moving_side(n, mol.bonds, bond)
                if moving:
                    c = apply_torsion(c, bond, moving, float(ang))
            cands.append(c)
    coords = np.asarray(cands, np.float32)
    spec = mol.to_spec(params=params, strict=False)
    asys = assemble_system([spec], relieve_clashes=False)
    return ConformerInputs(coords=coords, torsions=torsions,
                           topology=asys.topology,
                           cfg=MdConfig(dtype="float32"))


def _padded(coords: np.ndarray, n_pad: int, dtype, device) -> torch.Tensor:
    """[..., n, 3] float32 coordinates -> [..., n_pad, 3] with the padded
    rows at PAD_POSITION, in `dtype` on `device`."""
    width = [(0, 0)] * (coords.ndim - 2) + [(0, n_pad - coords.shape[-2]),
                                           (0, 0)]
    return torch.as_tensor(np.pad(coords, width,
                                  constant_values=PAD_POSITION),
                           dtype=dtype, device=device)


def vacuum_energy_fn(prep: ConformerInputs, device):
    """The vacuum allpairs energy of prep's topology on `device` in its
    config's dtype: (e_fn(x, box, couple), couple 1, padded width)."""
    dtype = getattr(torch, prep.cfg.dtype)
    top = prep.topology.to(device, dtype)
    e_fn = make_energy_fn(top, prep.cfg, "allpairs")
    return e_fn, torch.ones((), dtype=dtype, device=device), top.n_atoms


def conformer_energies(prep: ConformerInputs, device):
    """Vacuum energies of all candidates as one batched allpairs energy
    on `device`: (energies [C] tensor, {term: [C] tensor})."""
    e_fn, couple, n_pad = vacuum_energy_fn(prep, device)
    xp = _padded(prep.coords, n_pad, couple.dtype, device)

    def one(x):
        e, terms = e_fn(x, None, couple)
        return e, {k: terms[k] for k in TERM_KEYS}

    return torch.func.vmap(one)(xp)


def rank_conformers(prep: ConformerInputs, device,
                    minimize_best: bool = False) -> ConformerSet:
    """Sort the candidates by their batched vacuum energy on `device`;
    with minimize_best, FIRE 200 on the best one (the reference's
    fire_minimize: the returned energy is the final state's)."""
    energies, _ = conformer_energies(prep, device)
    energies = energies.cpu().numpy()
    order = np.argsort(energies)
    cset = ConformerSet(coords=prep.coords[order].astype(np.float64),
                        energies=energies[order], torsions=prep.torsions)
    if minimize_best:
        n = prep.n_atoms
        e_fn, couple, n_pad = vacuum_energy_fn(prep, device)
        x0 = _padded(cset.coords[0], n_pad, couple.dtype, device)
        dof = (torch.arange(n_pad, device=device) < n).to(couple.dtype)
        x_min, _ = fire_minimize(make_force_fn(e_fn), x0, None, couple, dof,
                                 n_steps=200)
        with torch.no_grad():
            e_min = e_fn(x_min, None, couple)[0]
        cset.coords[0] = x_min[:n].cpu().numpy()
        cset.energies[0] = float(e_min)
    return cset


def generate_conformers(
    mol: MoleculeCommon,
    n_conformers: int = 32,
    angles_per_torsion: int = 3,
    seed: int = 0,
    params=None,
    minimize_best: bool = False,
    device=None,
) -> ConformerSet:
    """Enumerate/sample torsion combinations, score in one vacuum batch on
    `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    prep = prepare_conformers(mol, n_conformers, angles_per_torsion, seed,
                              params)
    return rank_conformers(prep, dev, minimize_best)
