"""Mixing / solubility diagnostics over an MD snapshot (numpy copy of
molchanica_tpu.properties.mixing).

Reference parity: src/properties/mixing_analysis.rs — scores how well a
set of solute molecules is mixed with solvent: multi-scale local-mixing
kernels (sigma 4/7/10 A), solute dispersion, contact-cluster aggregation
penalty. The reference accelerates with a Barnes-Hut octree on CPU; here
the same quantities are direct vectorized distance computations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

KERNEL_SIGMAS_A = (4.0, 7.0, 10.0)
CONTACT_CUTOFF_A = 4.2
AGGREGATION_PENALTY_STRENGTH = 3.5
# log-expansion of the raw 0..1 score so poorly-soluble molecules don't all
# collapse to ~0 (reference mixing_analysis.rs log_expanded_solubility_score)
LOG_EXPANSION_GAIN = 20.0
EXPECTED_WATER_FLOOR = 4.0


@dataclass
class SolubilityMixingDiagnostics:
    score: float
    raw_score: float
    local_mixing: float
    solute_dispersion: float
    mixture_score: float
    aggregation_factor: float
    aggregation_penalty: float
    largest_cluster_fraction: float
    contacted_fraction: float
    contact_pair_fraction: float


def _min_image(d, box):
    if box is None:
        return d
    return d - box * np.round(d / box)


def _clusters(solute_com: np.ndarray, box, cutoff: float):
    """Union-find contact clustering of solute molecules."""
    n = len(solute_com)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    n_contact_pairs = 0
    contacted = np.zeros(n, bool)
    for i in range(n):
        d = _min_image(solute_com[i + 1:] - solute_com[i], box)
        r = np.linalg.norm(d, axis=-1)
        for k in np.nonzero(r < cutoff)[0]:
            j = i + 1 + int(k)
            n_contact_pairs += 1
            contacted[i] = contacted[j] = True
            ra, rb = find(i), find(j)
            if ra != rb:
                parent[ra] = rb
    sizes = {}
    for i in range(n):
        r = find(i)
        sizes[r] = sizes.get(r, 0) + 1
    largest = max(sizes.values()) if sizes else 1
    return largest / max(n, 1), contacted.mean() if n else 0.0, \
        n_contact_pairs / max(n * (n - 1) / 2, 1)


def solute_mol_centers(solute_pos: np.ndarray, atoms_per_solute: int,
                       box_extent=None) -> np.ndarray:
    """Periodic-safe per-copy centers: each molecule is unwrapped into its
    first atom's frame before averaging, then wrapped back into the cell
    (reference mixing_analysis.rs solute_mol_center)."""
    x = np.asarray(solute_pos, float).reshape(-1, atoms_per_solute, 3)
    box = None if box_extent is None else np.asarray(box_extent, float)
    anchor = x[:, :1]
    rel = _min_image(x - anchor, box)
    com = anchor[:, 0] + rel.mean(axis=1)
    if box is not None:
        com = com - box * np.floor(com / box)
    return com


def adapted_kernel_sigmas(box_extent) -> tuple:
    """Kernel scales clamped to the cell: sigma <= 0.9 * half the smallest
    extent, >= 1 A (reference solubility_kernel_sigmas)."""
    if box_extent is None:
        return KERNEL_SIGMAS_A
    half = 0.5 * max(float(np.min(np.asarray(box_extent, float))), 1.0)
    return tuple(min(s, 0.9 * half) if min(s, 0.9 * half) > 1.0 else 1.0
                 for s in KERNEL_SIGMAS_A)


def occupancy_count_score(observed: int, expected: float) -> float:
    """Saturating occupancy score: 0 when no solvent is present, ->1 as the
    observed count reaches/exceeds the bulk expectation (reference
    occupancy_count_score: (1-exp(-ratio)) normalized to ratio=1)."""
    if observed <= 0:
        return 0.0
    ratio = observed / max(expected, EXPECTED_WATER_FLOOR)
    return float(np.clip((1.0 - np.exp(-ratio)) / (1.0 - np.exp(-1.0)),
                         0.0, 1.0))


def partition_occupancy_score(solute_com: np.ndarray,
                              solvent_pos: np.ndarray,
                              box_extent, expansion: float = 2.0) -> float:
    """Grid-partition occupancy: the cell is split into ~M equal regions
    (the vectorized analog of the reference's per-solute octree leaves);
    each solute's region, expanded by `expansion` A, is scored by how close
    its water count comes to the bulk expectation, and the partition
    granularity is scored against the ideal one-solute-per-leaf volume
    (reference partition_size_score)."""
    box = np.asarray(box_extent, float)
    M = max(len(solute_com), 1)
    vol = float(np.prod(box))
    rho_w = len(solvent_pos) / vol
    # reference leaf volume: box volume / next power-of-8 >= M
    leaves = 1
    while leaves < M:
        leaves *= 8
    ref_leaf_vol = vol / leaves
    # each solute claims a sphere of the leaf's radius + expansion
    r_leaf = (3.0 * ref_leaf_vol / (4.0 * np.pi)) ** (1.0 / 3.0)
    r_eff = r_leaf + expansion
    occ = []
    for i in range(len(solute_com)):
        d = _min_image(solvent_pos - solute_com[i], box)
        n_in = int((np.sum(d * d, axis=-1) < r_eff * r_eff).sum())
        expect = rho_w * 4.0 / 3.0 * np.pi * r_eff ** 3
        occ.append(occupancy_count_score(n_in, expect))
    spacing = float(np.clip(np.sqrt(ref_leaf_vol / max(vol / M, 1e-9)),
                            0.0, 1.0))
    crowding = float(np.sqrt(1.0 / M))
    return float(np.mean(occ)) * max(spacing * crowding, 0.25) \
        if occ else 0.0


def log_expanded_score(raw: float) -> float:
    """Log-expand a 0..1 raw score (reference log_expanded_solubility_score):
    low raw scores get more dynamic range."""
    raw = float(np.clip(raw, 0.0, 1.0))
    return float(np.log(1.0 + LOG_EXPANSION_GAIN * raw)
                 / np.log(1.0 + LOG_EXPANSION_GAIN))


def map_to_aqsoldb(v: float) -> float:
    """Linear map from this library's 0..1 scale onto AqSolDB's logS range
    (reference map_to_aqsoldb: (0,1) -> (-4, 2))."""
    return -4.0 + 6.0 * float(v)


def valid_solubility_cell(box_extent) -> bool:
    if box_extent is None:
        return False
    box = np.asarray(box_extent, float)
    return bool(np.all(np.isfinite(box)) and np.all(box > 2.0))


def compute_solubility(solute_pos: np.ndarray, atoms_per_solute: int,
                       solvent_pos: np.ndarray, box_extent,
                       heavy_mask: Optional[np.ndarray] = None) -> float:
    """Single-frame solubility estimate on the log-expanded 0..1 scale
    (reference compute_solubility: intended to ORDER solutes correctly;
    absolute scale arbitrary). Use `map_to_aqsoldb` for a logS-like value.
    """
    if not valid_solubility_cell(box_extent):
        return 0.0
    x = np.asarray(solute_pos, float)
    if heavy_mask is not None:
        # score on heavy atoms only (the reference's solute_atom_indices
        # "may exclude hydrogens")
        sel = x.reshape(-1, atoms_per_solute, 3)[:, np.asarray(heavy_mask)]
        atoms_per_solute = sel.shape[1]
        x = sel.reshape(-1, 3)
    com = solute_mol_centers(x, atoms_per_solute, box_extent)
    diag = mixing_diagnostics(com, solvent_pos, box_extent)
    occ = partition_occupancy_score(com, np.asarray(solvent_pos, float),
                                    box_extent)
    raw = 0.7 * diag.raw_score + 0.3 * occ
    return log_expanded_score(raw)


def compute_solubility_trajectory(frames, atoms_per_solute: int,
                                  solvent_frames, box_extent,
                                  last_k: int = 5) -> float:
    """Trajectory-level estimate: mean of the last `last_k` frames (the
    reference scores the final frame; averaging a short tail is strictly
    more robust to single-frame fluctuation)."""
    frames = list(frames)[-last_k:]
    solvent_frames = list(solvent_frames)[-last_k:]
    if not frames:
        return 0.0
    return float(np.mean([
        compute_solubility(f, atoms_per_solute, w, box_extent)
        for f, w in zip(frames, solvent_frames)]))


def mixing_diagnostics(
    solute_com: np.ndarray,          # [M, 3] per-solute-molecule centers
    solvent_pos: np.ndarray,         # [W, 3] solvent heavy-atom positions
    box_extent: Optional[np.ndarray] = None,
) -> SolubilityMixingDiagnostics:
    """Score in [0, 1]: 1 = well-mixed/dispersed, 0 = phase-separated."""
    solute_com = np.asarray(solute_com, float)
    solvent_pos = np.asarray(solvent_pos, float)
    box = None if box_extent is None else np.asarray(box_extent, float)
    M = len(solute_com)
    vol = float(np.prod(box)) if box is not None else \
        float(np.ptp(solvent_pos, axis=0).prod() + 1e-9)
    rho_w = len(solvent_pos) / vol

    # local mixing: observed local solvent density around each solute vs
    # the bulk expectation, averaged over kernel scales
    mix_scales = []
    for sig in adapted_kernel_sigmas(box):
        loc = []
        norm = (2 * np.pi * sig * sig) ** 1.5
        for i in range(M):
            d = _min_image(solvent_pos - solute_com[i], box)
            r2 = np.sum(d * d, axis=-1)
            w = np.exp(-0.5 * r2 / (sig * sig))
            loc.append(w.sum() / (norm * rho_w + 1e-12))
        mix_scales.append(np.clip(np.mean(loc), 0.0, 1.5))
    local_mixing = float(np.clip(np.mean(mix_scales), 0.0, 1.0))

    # dispersion: mean nearest-neighbor solute distance vs the ideal-gas
    # expectation (0.554 * rho^{-1/3})
    if M > 1:
        nn = []
        for i in range(M):
            d = _min_image(np.delete(solute_com, i, axis=0)
                           - solute_com[i], box)
            nn.append(np.linalg.norm(d, axis=-1).min())
        expect = 0.554 * (vol / M) ** (1.0 / 3.0)
        solute_dispersion = float(np.clip(np.mean(nn) / expect, 0.0, 1.0))
    else:
        solute_dispersion = 1.0

    mixture_score = 0.5 * (local_mixing + solute_dispersion)

    largest_frac, contacted_frac, pair_frac = (
        _clusters(solute_com, box, CONTACT_CUTOFF_A) if M > 1
        else (1.0 / max(M, 1), 0.0, 0.0))
    aggregation_factor = float(np.clip(largest_frac, 0.0, 1.0))
    aggregation_penalty = AGGREGATION_PENALTY_STRENGTH * \
        max(aggregation_factor - 1.0 / max(M, 1), 0.0) ** 2

    raw = mixture_score - aggregation_penalty
    return SolubilityMixingDiagnostics(
        score=float(np.clip(raw, 0.0, 1.0)),
        raw_score=float(raw),
        local_mixing=local_mixing,
        solute_dispersion=solute_dispersion,
        mixture_score=float(mixture_score),
        aggregation_factor=aggregation_factor,
        aggregation_penalty=float(aggregation_penalty),
        largest_cluster_fraction=float(largest_frac),
        contacted_fraction=float(contacted_frac),
        contact_pair_fraction=float(pair_frac),
    )
