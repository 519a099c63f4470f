"""Molecular 3D alignment: rigid (Kabsch) and MD-driven flexible alignment
(port of molchanica_tpu.molecules.alignment).

The rigid stage is the reference's numpy code. The flexible stage runs the
port's MdSim on the device, with the harmonic pull as tensors there.

Reference: src/mol_alignment.rs — ring-first rigid alignment (1000/60
rotations, :33-35), per-rotatable-bond search (:39), then flexible alignment
by injecting synthetic per-atom forces through `md.step(..., Some(forces))`
(:338) — exactly our engine's `external_forces_fn` hook.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import MoleculeCommon


def kabsch(P: np.ndarray, Q: np.ndarray,
           weights: Optional[np.ndarray] = None
           ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Optimal rotation R and translation t mapping P -> Q (weighted).
    Returns (R, t, rmsd)."""
    P = np.asarray(P, float)
    Q = np.asarray(Q, float)
    w = (np.ones(len(P)) if weights is None
         else np.asarray(weights, float))
    w = w / w.sum()
    pc = (P * w[:, None]).sum(0)
    qc = (Q * w[:, None]).sum(0)
    P0, Q0 = P - pc, Q - qc
    H = (P0 * w[:, None]).T @ Q0
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    D = np.diag([1.0, 1.0, d])
    R = Vt.T @ D @ U.T
    t = qc - R @ pc
    aligned = P @ R.T + t
    rmsd = float(np.sqrt((w * ((aligned - Q) ** 2).sum(1)).sum()))
    return R, t, rmsd


def kabsch_rmsd(P: np.ndarray, Q: np.ndarray) -> float:
    """Minimum RMSD between two same-order coordinate sets."""
    return kabsch(P, Q)[2]


@dataclass
class AlignmentResult:
    positions: np.ndarray
    rmsd: float
    matched_pairs: List[Tuple[int, int]]


def _feature_pairs(mol_a: MoleculeCommon, mol_b: MoleculeCommon,
                   max_pairs: int = 16) -> List[Tuple[int, int]]:
    """Greedy correspondence between similar-environment heavy atoms."""
    ea = [e.capitalize() for e in mol_a.elements]
    eb = [e.capitalize() for e in mol_b.elements]
    adj_a, adj_b = mol_a.adjacency(), mol_b.adjacency()

    def sig(el, adj, i):
        nbrs = sorted(el[j] for j in adj[i])
        return (el[i], len(nbrs), tuple(nbrs))

    sig_b: dict = {}
    for i in range(len(eb)):
        if eb[i] == "H":
            continue
        sig_b.setdefault(sig(eb, adj_b, i), []).append(i)
    pairs = []
    used_b: set = set()
    for i in range(len(ea)):
        if ea[i] == "H":
            continue
        for j in sig_b.get(sig(ea, adj_a, i), []):
            if j not in used_b:
                pairs.append((i, j))
                used_b.add(j)
                break
        if len(pairs) >= max_pairs:
            break
    return pairs


def rigid_align(mol: MoleculeCommon, template: MoleculeCommon,
                n_orientations: int = 60) -> AlignmentResult:
    """Rigid alignment: feature correspondence + Kabsch; falls back to an
    orientation search over centroid-matched rotations when correspondences
    are scarce (reference ring-first rigid stage)."""
    pairs = _feature_pairs(mol, template)
    x = np.asarray(mol.positions, float)
    xt = np.asarray(template.positions, float)
    if len(pairs) >= 3:
        ia = [p[0] for p in pairs]
        ib = [p[1] for p in pairs]
        R, t, rmsd = kabsch(x[ia], xt[ib])
        return AlignmentResult(x @ R.T + t, rmsd, pairs)
    # orientation search: best centroid-overlap of heavy atoms
    from ..docking.poses import fibonacci_orientations, quat_to_mat
    heavy_a = [i for i, e in enumerate(mol.elements) if e != "H"]
    heavy_b = [i for i, e in enumerate(template.elements) if e != "H"]
    ca, cb = x[heavy_a].mean(0), xt[heavy_b].mean(0)
    best = (np.inf, x)
    for R in quat_to_mat(fibonacci_orientations(n_orientations)):
        cand = (x - ca) @ R.T + cb
        d = cand[heavy_a][:, None, :] - xt[heavy_b][None, :, :]
        score = float(np.sqrt((d ** 2).sum(-1)).min(axis=1).mean())
        if score < best[0]:
            best = (score, cand)
    return AlignmentResult(best[1], best[0], [])


def alignment_sim(mol: MoleculeCommon, template: MoleculeCommon,
                  k_pull: float = 10.0, temp: float = 50.0, params=None,
                  seed: int = 0, device=None, relax=None):
    """The flexible stage's MdSim on `device` (None: the CUDA card): the
    molecule at its rigid prealignment in vacuum, Langevin at `temp`, the
    harmonic pull toward the matched template sites as its external
    force, FIRE 200 at construction unless `relax` is False. Returns
    (sim, rigid AlignmentResult, matched pairs)."""
    from ..device import resolve_device
    from ..md import engine
    from ..md.config import HydrogenConstraint, Integrator, MdConfig
    from .spec import assemble_system

    dev = resolve_device(device)
    rigid = rigid_align(mol, template)
    pairs = rigid.matched_pairs or _feature_pairs(mol, template)
    spec = mol.to_spec(params=params, strict=False)
    spec.positions = rigid.positions
    asys = assemble_system([spec], relieve_clashes=False)
    top = asys.topology
    n_pad = top.n_atoms

    targets = np.full((n_pad, 3), 0.0, np.float32)
    pull = np.zeros((n_pad,), np.float32)
    xt = np.asarray(template.positions, float)
    for i, j in pairs:
        targets[i] = xt[j]
        pull[i] = k_pull

    cfg = MdConfig(
        integrator=Integrator.langevin_middle(gamma=10.0),
        temp_target=temp, dtype="float32",
        hydrogen_constraint=HydrogenConstraint.flexible(),
        max_init_relaxation_iters=200, zero_com_drift=False, seed=seed)
    dtype = getattr(torch, cfg.dtype)
    targets_t = torch.as_tensor(targets, dtype=dtype, device=dev)
    pull_t = torch.as_tensor(pull, dtype=dtype, device=dev)[:, None]

    def external_forces(x):
        return -pull_t * (x - targets_t)

    x0 = np.zeros((n_pad, 3), np.float32)
    x0[:len(rigid.positions)] = rigid.positions
    x0[len(rigid.positions):] = 1e4
    sim = engine.MdSim(top, cfg, x0, external_forces_fn=external_forces,
                       relax=relax, device=dev)
    return sim, rigid, pairs


def flexible_align(
    mol: MoleculeCommon,
    template: MoleculeCommon,
    n_steps: int = 400,
    k_pull: float = 10.0,
    dt_ps: float = 0.001,
    temp: float = 50.0,
    params=None,
    seed: int = 0,
    device=None,
) -> AlignmentResult:
    """MD-driven flexible alignment: rigid prealign, then Langevin dynamics
    with harmonic pull forces toward matched template sites injected via the
    engine's external-force hook (reference mol_alignment.rs:338), on
    `device` (None: the CUDA card)."""
    sim, rigid, pairs = alignment_sim(mol, template, k_pull, temp, params,
                                      seed, device)
    sim.step(dt_ps, n_steps, force_cap=500.0)
    out = sim.state.positions[:mol.n_atoms].cpu().numpy()
    xt = np.asarray(template.positions, float)
    ia = [p[0] for p in pairs]
    ib = [p[1] for p in pairs]
    rmsd = float(np.sqrt(((out[ia] - xt[ib]) ** 2).sum(1).mean())) \
        if pairs else rigid.rmsd
    return AlignmentResult(out, rmsd, pairs)
