"""Batched pose scoring (port of molchanica_tpu.docking.scorer).

Reference scoring (src/docking/legacy/mod.rs:217 + BindingEnergy weights at
:167-208): LJ sum + H-bond counting (both directions) + hydrophobic contact
well + Coulomb -> weighted score; VdW clash pre-culling (process_poses,
:511). The JAX package vmaps one pose's [L, R] evaluation over the poses;
here a batch of B poses is one [B, L, R] broadcast in plain torch with the
same operations in the same order: r^2 floored at 1e-4, LJ clipped to
+-1e5 per pair and masked, Coulomb, the H-bond and hydrophobic Gaussian
wells, the clash test, the weighted total set to +inf on a clash. Only the
order of the float32 sums over the [L, R] pairs differs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import COULOMB_CONST
from ..device import resolve_device
from .setup import DockingSetup

# Weighted-score coefficients (BindingEnergy analog; the reference's exact
# weights live in src/docking/legacy/mod.rs:167-208 — these are the same
# shape of linear combination, tuned loosely).
W_LJ = 1.0
W_COULOMB = 0.15
W_HBOND = -1.2        # kcal/mol per geometric H-bond
W_HYDROPHOBIC = -0.15 # per apolar contact in the well

HB_DIST = 2.6         # H...acceptor distance for a full H-bond (A)
HB_WIDTH = 0.6
PHOBIC_R0 = 4.0
PHOBIC_WIDTH = 1.0
CLASH_R = 1.6         # VdW clash-cull distance (process_poses analog)

TERMS = ("lj", "coulomb", "h_bonds", "hydrophobic")
# the weight of each term in the total
WEIGHTS = dict(lj=W_LJ, coulomb=W_COULOMB, h_bonds=W_HBOND,
               hydrophobic=W_HYDROPHOBIC)
DEFAULT_BATCH = 4096


@dataclass
class BindingEnergy:
    """Per-pose score breakdown (reference BindingEnergy)."""
    total: np.ndarray       # [P] weighted score
    lj: np.ndarray
    coulomb: np.ndarray
    h_bonds: np.ndarray
    hydrophobic: np.ndarray
    clash: np.ndarray       # bool: True = culled


def _ligand_classes(ligand, elements):
    """Ligand donor / acceptor / hydrophobic flags (float32), as the
    reference classifies them."""
    if elements is not None:
        el = [e.capitalize() for e in elements]
        qn = np.asarray(ligand.charges)
        ldonor = np.array([1.0 if (e == "H" and q > 0.25) else 0.0
                           for e, q in zip(el, qn)], np.float32)
        lacceptor = np.array([1.0 if e in ("N", "O") else 0.0 for e in el],
                             np.float32)
        lphobic = np.array([1.0 if (e == "C" and abs(q) < 0.2) else 0.0
                            for e, q in zip(el, qn)], np.float32)
    else:
        mn = np.asarray(ligand.masses)
        qn = np.asarray(ligand.charges)
        ldonor = ((mn < 2.0) & (qn > 0.25)).astype(np.float32)
        lacceptor = ((mn > 13.0) & (mn < 17.5) & (qn < -0.3)).astype(
            np.float32)
        lphobic = ((np.abs(qn) < 0.2) & (mn > 11.0) & (mn < 13.0)).astype(
            np.float32)
    return ldonor, lacceptor, lphobic


def make_pose_scorer(setup: DockingSetup, ligand, elements=None,
                     device=None, magnitudes=False):
    """Build score(poses [B, L, 3]) -> dict of per-pose tensors on `device`
    (None: the CUDA card; the setup's tensors are moved there).

    `ligand`: MolSpec-like with charges/lj_sigma/lj_eps. `elements` enables
    ligand donor/acceptor/hydrophobic classification. With `magnitudes`,
    the dict also holds, per term, the scale that two float32 evaluations
    of it are held to (`<term>_abs`): the sum of the magnitudes of the
    pose's pair terms, each Gaussian well term weighted by (1 + x), x its
    exponent ((r - r0) / w)^2. float32 rounds x to within x eps, so a term
    exp(-x) is only known to within x eps of itself: a pose whose wells
    come from tail pairs at x of 50-100 (r 11-14 A) parts from another
    evaluation by ~1.5e-5 of the plain magnitudes, none of it the sum.
    """
    dev = resolve_device(device)
    s = setup.to(dev)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    lq, lsig, leps = t(ligand.charges), t(ligand.lj_sigma), t(ligand.lj_eps)
    ldonor, lacceptor, lphobic = (
        t(a) for a in _ligand_classes(ligand, elements))
    rp, rq = s.rec_pos, s.rec_q
    rsig, reps, rmask = s.rec_sigma, s.rec_eps, s.rec_mask
    rdon, racc, rphob = s.rec_donor, s.rec_acceptor, s.rec_hydrophobic

    # the pose-independent [L, R] factors, formed as the reference forms them
    sig = 0.5 * (lsig[:, None] + rsig[None, :])
    sig2 = sig * sig
    eps4 = 4.0 * torch.sqrt(leps[:, None] * reps[None, :])
    qq = COULOMB_CONST * lq[:, None] * rq[None, :]
    hb_pair = (ldonor[:, None] * racc[None, :]
               + lacceptor[:, None] * rdon[None, :])
    phob_pair = lphobic[:, None] * rphob[None, :]
    can_clash = ((rmask[None, :] > 0) & (leps[:, None] > 1e-6)
                 & (reps[None, :] > 1e-6))
    m = rmask[None, None, :]

    @torch.no_grad()
    def score(poses):
        poses = torch.as_tensor(poses, dtype=torch.float32, device=dev)
        d = poses[:, :, None, 0] - rp[None, None, :, 0]      # [B, L, R]
        r2 = d * d
        for k in (1, 2):
            d = poses[:, :, None, k] - rp[None, None, :, k]
            r2 = r2 + d * d
        del d
        r2 = torch.clamp(r2, min=1e-4)
        r = torch.sqrt(r2)
        u = sig2 / r2
        s6 = u * u * u
        del u, r2
        pair = {}
        pair["lj"] = torch.clamp(eps4 * (s6 * s6 - s6), -1e5, 1e5) * m
        del s6
        pair["coulomb"] = qq / r * m
        x_hb = ((r - HB_DIST) / HB_WIDTH) ** 2
        pair["h_bonds"] = hb_pair * torch.exp(-x_hb) * m
        x_phob = ((r - PHOBIC_R0) / PHOBIC_WIDTH) ** 2
        pair["hydrophobic"] = phob_pair * torch.exp(-x_phob) * m
        cond = dict(h_bonds=x_hb, hydrophobic=x_phob)
        del x_hb, x_phob
        clash = ((r < CLASH_R) & can_clash).flatten(1).any(dim=1)
        del r
        out = {k: v.sum(dim=(1, 2)) for k, v in pair.items()}
        if magnitudes:
            for k, v in pair.items():
                a = v.abs() if k not in cond else v.abs() * (1.0 + cond[k])
                out[f"{k}_abs"] = a.sum(dim=(1, 2))
        del pair, cond
        total = (W_LJ * out["lj"] + W_COULOMB * out["coulomb"]
                 + W_HBOND * out["h_bonds"]
                 + W_HYDROPHOBIC * out["hydrophobic"])
        out["total"] = torch.where(clash, torch.full_like(total, np.inf),
                                   total)
        out["clash"] = clash
        return out

    return score


def _score_batched(scorer, poses, batch_size, dev):
    """Every key of scorer's output over [P, L, 3] poses in batches of
    batch_size (the last pose repeated to fill the final batch, as the
    reference does), as numpy arrays of length P."""
    poses = np.asarray(poses, np.float32)
    n = len(poses)
    pad = (-n) % batch_size
    if pad:
        poses = np.concatenate([poses, np.repeat(poses[-1:], pad, 0)])
    x = torch.as_tensor(poses, device=dev)
    outs = None
    for b in range(0, len(poses), batch_size):
        res = scorer(x[b:b + batch_size])
        if outs is None:
            outs = {k: [] for k in res}
        for k, v in res.items():
            outs[k].append(v)
    return {k: torch.cat(v)[:n].cpu().numpy() for k, v in outs.items()}


def score_poses(setup: DockingSetup, ligand, poses, elements=None,
                batch_size: int = DEFAULT_BATCH,
                device=None) -> BindingEnergy:
    """Score [P, L, 3] poses in device batches (`device` None: the CUDA
    card); returns BindingEnergy of numpy arrays."""
    dev = resolve_device(device)
    cat = _score_batched(make_pose_scorer(setup, ligand, elements, dev),
                         poses, batch_size, dev)
    return BindingEnergy(
        total=cat["total"], lj=cat["lj"], coulomb=cat["coulomb"],
        h_bonds=cat["h_bonds"], hydrophobic=cat["hydrophobic"],
        clash=cat["clash"])


def pose_term_magnitudes(setup: DockingSetup, ligand, poses, elements=None,
                         batch_size: int = DEFAULT_BATCH,
                         device=None) -> dict:
    """Per term and pose the scale of make_pose_scorer's `magnitudes` (the
    sum of the magnitudes of its pair terms, the wells' weighted by 1 + x),
    and under "total" the weighted sum of those: the scales a comparison of
    two float32 evaluations of score_poses is held to."""
    dev = resolve_device(device)
    cat = _score_batched(
        make_pose_scorer(setup, ligand, elements, dev, magnitudes=True),
        poses, batch_size, dev)
    out = {k: cat[f"{k}_abs"].astype(np.float64) for k in TERMS}
    out["total"] = sum(abs(WEIGHTS[k]) * out[k] for k in TERMS)
    return out


def find_optimal_pose(setup: DockingSetup, ligand, poses, elements=None,
                      top_k: int = 10, device=None):
    """Reference find_optimal_pose (legacy/mod.rs:694): score all, return the
    best poses sorted by weighted score."""
    be = score_poses(setup, ligand, poses, elements, device=device)
    order = np.argsort(be.total)
    return order[:top_k], be
