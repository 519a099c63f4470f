"""Static topology: the per-atom force field and bonded index lists as torch
tensors (port of molchanica_tpu.topology).

Functional forms (Amber family):

  bond      : k (r - r0)^2
  angle     : k (theta - theta0)^2
  dihedral  : k (1 + cos(n phi - phase))      (impropers use the same form)
  LJ        : 4 eps ((sigma/r)^12 - (sigma/r)^6), Lorentz-Berthelot mixing
  Coulomb   : COULOMB_CONST q_i q_j / r

1-2 and 1-3 pairs are fully excluded; 1-4 pairs are scaled by 1/scee
(Coulomb) and 1/scnb (LJ) on their own pair list. Every array has a fixed
shape: padding rows carry zero force constants and masks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

# Tensor fields, in the reference Topology's order. Integer fields hold
# indices or ids and become int64 (torch's index type); the rest float32.
TENSOR_FIELDS = (
    "masses", "charges", "lj_sigma", "lj_eps", "atom_mask", "dof_mask",
    "mol_id", "bond_idx", "bond_k", "bond_r0", "angle_idx", "angle_k",
    "angle_theta0", "dihedral_idx", "dihedral_k", "dihedral_n",
    "dihedral_phase", "excl_idx", "excl_mask", "pair14_idx", "pair14_mask",
    "pair14_scee", "pair14_scnb", "couple_mask", "vsite_idx",
    "vsite_weight", "vsite_mask", "hcluster_heavy", "hcluster_h",
    "hcluster_r0",
)
STATIC_FIELDS = (
    "water_start", "water_count", "water_site_count", "water_r_oh",
    "water_theta_hoh", "water_r_om", "n_atoms_real", "n_mol",
)


@dataclass
class Topology:
    # --- per-atom static properties ---
    masses: torch.Tensor       # [N] amu; padding atoms get mass 1, mask 0
    charges: torch.Tensor      # [N] e
    lj_sigma: torch.Tensor     # [N] A
    lj_eps: torch.Tensor       # [N] kcal/mol
    atom_mask: torch.Tensor    # [N] 1 real atom / 0 padding
    dof_mask: torch.Tensor     # [N] 1 integrated dof / 0 virtual site,
                               # frozen or padding
    mol_id: torch.Tensor       # [N] molecule index
    # --- bonded terms (index rows padded with 0, masked) ---
    bond_idx: torch.Tensor     # [B, 2]
    bond_k: torch.Tensor
    bond_r0: torch.Tensor
    angle_idx: torch.Tensor    # [A, 3]
    angle_k: torch.Tensor
    angle_theta0: torch.Tensor
    dihedral_idx: torch.Tensor  # [D, 4] (proper + improper, one row/term)
    dihedral_k: torch.Tensor
    dihedral_n: torch.Tensor
    dihedral_phase: torch.Tensor
    # --- nonbonded exclusions ---
    excl_idx: torch.Tensor     # [E, 2] fully excluded pairs (1-2, 1-3)
    excl_mask: torch.Tensor
    pair14_idx: torch.Tensor   # [P, 2]
    pair14_mask: torch.Tensor
    pair14_scee: torch.Tensor
    pair14_scnb: torch.Tensor
    # --- alchemical ---
    couple_mask: torch.Tensor  # [N]
    # --- virtual sites (4-site water M): M = O + w ((H1-O) + (H2-O)) ---
    vsite_idx: torch.Tensor    # [V, 4] (m, o, h1, h2)
    vsite_weight: torch.Tensor
    vsite_mask: torch.Tensor
    # --- H-constraint clusters (heavy atom + up to 3 hydrogens) ---
    hcluster_heavy: torch.Tensor  # [C]
    hcluster_h: torch.Tensor      # [C, 3] (-1 pad)
    hcluster_r0: torch.Tensor     # [C, 3]
    # --- statics: waters are contiguous (O, H1, H2[, M]) blocks ---
    water_start: int = 0
    water_count: int = 0
    water_site_count: int = 0
    water_r_oh: float = 0.0
    water_theta_hoh: float = 0.0
    water_r_om: float = 0.0
    n_atoms_real: int = 0
    n_mol: int = 1

    @property
    def n_atoms(self) -> int:
        return self.masses.shape[0]

    def to(self, device, dtype=None) -> "Topology":
        """A copy with every tensor field on `device`; with `dtype`, the
        floating-point fields also cast to it (index fields stay int64)."""
        def conv(t):
            t = t.to(device)
            return t.to(dtype) if dtype is not None and t.is_floating_point() \
                else t
        return dataclasses.replace(
            self, **{f: conv(getattr(self, f)) for f in TENSOR_FIELDS})


def topology_from_numpy(fields: dict, statics: dict, device="cpu",
                        dtype=torch.float32) -> Topology:
    """Topology from numpy arrays keyed by field name (the reference
    Topology's fields, e.g. ``np.asarray(top.masses)``) plus its statics;
    floating-point fields in `dtype`."""
    def conv(a):
        a = np.asarray(a)
        dt = torch.int64 if np.issubdtype(a.dtype, np.integer) else dtype
        return torch.tensor(a, dtype=dt, device=device)

    return Topology(**{f: conv(fields[f]) for f in TENSOR_FIELDS},
                    **{s: statics[s] for s in STATIC_FIELDS})


def _pad2(a: np.ndarray, n: int, fill) -> np.ndarray:
    if a.shape[0] >= n:
        return a[:n]
    pad = np.full((n - a.shape[0],) + a.shape[1:], fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def make_topology(
    masses,
    charges,
    lj_sigma,
    lj_eps,
    bonds=None,          # list of (i, j, k, r0)
    angles=None,         # list of (i, j, k, k_theta, theta0)
    dihedrals=None,      # list of (i, j, k, l, k_phi, n, phase)
    pairs14=None,        # list of (i, j) or (i, j, scee, scnb)
    exclusions=None,     # list of (i, j) fully excluded; if None, derived
    mol_id=None,
    couple_mask=None,
    pad_atoms_to: Optional[int] = None,
    pad_terms_to_multiple: int = 128,
    water_start: int = 0,
    water_count: int = 0,
    water_site_count: int = 0,
    water_geometry=(0.0, 0.0, 0.0),
    hclusters=None,      # list of (heavy, [h...], [r0...])
    dof_mask=None,       # per-atom; default: 1 for real atoms
    vsites=None,         # list of (m, o, h1, h2, weight)
    dtype=torch.float32,
) -> Topology:
    """Fixed-shape Topology from host-side python/numpy data.

    Exclusions default to the 1-2 and 1-3 pairs of the bonds and angles;
    1-4 pairs default to the dihedral end atoms not already excluded. The
    tensors live on the CPU, floating-point ones in `dtype`; engines move
    what they use.
    """
    masses = np.asarray(masses, np.float64)
    n_real = masses.shape[0]
    n = pad_atoms_to or n_real
    assert n >= n_real

    bonds = list(bonds or [])
    angles = list(angles or [])
    dihedrals = list(dihedrals or [])

    if exclusions is None:
        excl = set()
        for b in bonds:
            i, j = int(b[0]), int(b[1])
            excl.add((min(i, j), max(i, j)))
        for a in angles:
            i, k = int(a[0]), int(a[2])
            excl.add((min(i, k), max(i, k)))
        exclusions = sorted(excl)
    else:
        exclusions = sorted({(min(int(i), int(j)), max(int(i), int(j)))
                             for i, j in exclusions})
    excl_set = set(exclusions)

    if pairs14 is None:
        p14 = set()
        for d in dihedrals:
            i, l = int(d[0]), int(d[3])
            key = (min(i, l), max(i, l))
            if key not in excl_set and i != l:
                p14.add(key)
        pairs14 = sorted(p14)
    pairs14_full = [(p[0], p[1], 1.2, 2.0) if len(p) == 2 else tuple(p)
                    for p in pairs14]

    def padded_len(k):
        m = pad_terms_to_multiple
        return max(m, ((k + m - 1) // m) * m)

    def term_arrays(rows, ncol_idx, n_vals):
        kp = padded_len(len(rows))
        idx = np.zeros((kp, ncol_idx), np.int32)
        vals = [np.zeros((kp,), np.float64) for _ in range(n_vals)]
        mask = np.zeros((kp,), np.float64)
        for r, row in enumerate(rows):
            idx[r] = [int(v) for v in row[:ncol_idx]]
            for c in range(n_vals):
                vals[c][r] = float(row[ncol_idx + c])
            mask[r] = 1.0
        return idx, vals, mask

    b_idx, (b_k, b_r0), _ = term_arrays(bonds, 2, 2)
    a_idx, (a_k, a_t0), _ = term_arrays(angles, 3, 2)
    d_idx, (d_k, d_n, d_ph), _ = term_arrays(dihedrals, 4, 3)
    e_idx, _, e_mask = term_arrays([(i, j, 0.0) for i, j in exclusions],
                                   2, 1)
    p_idx, (p_scee, p_scnb), p_mask = term_arrays(pairs14_full, 2, 2)
    # padded 1-4 divisors must be nonzero to avoid 0/0
    p_scee[p_mask == 0] = 1.0
    p_scnb[p_mask == 0] = 1.0

    atom_mask = np.zeros((n,), np.float64)
    atom_mask[:n_real] = 1.0
    if mol_id is None:
        mol_id = np.zeros((n_real,), np.int32)
    mol_id = _pad2(np.asarray(mol_id, np.int32), n, 0)
    n_mol = int(mol_id.max()) + 1 if n_real else 1
    if couple_mask is None:
        couple_mask = np.zeros((n_real,), np.float64)

    if dof_mask is None:
        dof_mask = np.ones((n_real,), np.float64)
    dof_mask = np.asarray(dof_mask, np.float64).copy()

    vsites = list(vsites or [])
    vp = padded_len(len(vsites)) if vsites else pad_terms_to_multiple
    vs_idx = np.full((vp, 4), 0, np.int32)
    vs_w = np.zeros((vp,), np.float64)
    vs_mask = np.zeros((vp,), np.float64)
    for r, (m_i, o_i, h1_i, h2_i, w) in enumerate(vsites):
        vs_idx[r] = (m_i, o_i, h1_i, h2_i)
        vs_w[r] = w
        vs_mask[r] = 1.0
        dof_mask[m_i] = 0.0  # M sites are not integrated dofs

    hclusters = list(hclusters or [])
    cp = padded_len(len(hclusters)) if hclusters else pad_terms_to_multiple
    hc_heavy = np.zeros((cp,), np.int32)
    hc_h = np.full((cp, 3), -1, np.int32)
    hc_r0 = np.zeros((cp, 3), np.float64)
    for r, (heavy, hs, r0s) in enumerate(hclusters):
        hc_heavy[r] = heavy
        if len(hs) > 3:
            # star M-SHAKE solves a 3x3 system per cluster: keep the first
            # three X-H bonds constrained and leave the rest flexible
            import warnings
            warnings.warn(
                f"H-cluster at atom {heavy} has {len(hs)} hydrogens; "
                "only 3 are constrained (star M-SHAKE limit)")
        for ci, (h, r0) in enumerate(zip(hs[:3], r0s[:3])):
            hc_h[r, ci] = h
            hc_r0[r, ci] = r0

    fields = dict(
        masses=_pad2(masses, n, 1.0),
        charges=_pad2(np.asarray(charges, np.float64), n, 0.0),
        lj_sigma=_pad2(np.asarray(lj_sigma, np.float64), n, 1.0),
        lj_eps=_pad2(np.asarray(lj_eps, np.float64), n, 0.0),
        atom_mask=atom_mask,
        dof_mask=_pad2(dof_mask, n, 0.0),
        mol_id=mol_id,
        bond_idx=b_idx, bond_k=b_k, bond_r0=b_r0,
        angle_idx=a_idx, angle_k=a_k, angle_theta0=a_t0,
        dihedral_idx=d_idx, dihedral_k=d_k, dihedral_n=d_n,
        dihedral_phase=d_ph,
        excl_idx=e_idx, excl_mask=e_mask,
        pair14_idx=p_idx, pair14_mask=p_mask,
        pair14_scee=p_scee, pair14_scnb=p_scnb,
        couple_mask=_pad2(np.asarray(couple_mask, np.float64), n, 0.0),
        vsite_idx=vs_idx, vsite_weight=vs_w, vsite_mask=vs_mask,
        hcluster_heavy=hc_heavy, hcluster_h=hc_h, hcluster_r0=hc_r0,
    )
    statics = dict(
        water_start=water_start, water_count=water_count,
        water_site_count=water_site_count,
        water_r_oh=float(water_geometry[0]),
        water_theta_hoh=float(water_geometry[1]),
        water_r_om=float(water_geometry[2]),
        n_atoms_real=n_real, n_mol=n_mol,
    )
    return topology_from_numpy(fields, statics, dtype=dtype)
