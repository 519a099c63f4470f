"""Holonomic constraints for MdSim: rigid water and X-H bonds by cluster
M-SHAKE/RATTLE (port of molchanica_tpu.md.constraints).

Constraints are grouped into independent clusters of <= 4 atoms and <= 3
constraints (a water, or a heavy atom with its bonded hydrogens). Each
cluster solves a 3x3 linear system per iteration (Cramer's rule); 8 fixed
iterations reach float32 precision. All clusters solve at once with one
gather and one scatter back; no atom is in two clusters, and the padded
slots of a cluster point at atom 0 with slot_valid 0, so the scatter adds
zero there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.pbc import minimum_image


def _np(t):
    return t.detach().cpu().numpy()


def _build_clusters(top):
    """Host side: waters and H clusters as padded cluster arrays.

    Returns (atom_idx [C, 4] (-1 pad), dists [C, 3], con_mask [C, 3],
    n_constraints, is_water [C]) or None without constraints."""
    clusters = []   # (atoms[4], dists[3], mask[3])
    if top.water_count > 0:
        r_oh = top.water_r_oh
        r_hh = 2.0 * r_oh * math.sin(0.5 * top.water_theta_hoh)
        stride = top.water_site_count
        for w in range(top.water_count):
            o = top.water_start + w * stride
            clusters.append(([o, o + 1, o + 2, -1],
                             [r_oh, r_oh, r_hh], [1.0, 1.0, 1.0]))
    hc_heavy = _np(top.hcluster_heavy)
    hc_h = _np(top.hcluster_h)
    hc_r0 = _np(top.hcluster_r0)
    for c in range(hc_heavy.shape[0]):
        hs = hc_h[c]
        if (hs < 0).all():
            continue
        atoms = [int(hc_heavy[c])] + [int(h) for h in hs]
        dists, mask = [], []
        for k in range(3):
            if hs[k] >= 0:
                dists.append(float(hc_r0[c, k]))
                mask.append(1.0)
            else:
                dists.append(1.0)
                mask.append(0.0)
        clusters.append((atoms, dists, mask))
    if not clusters:
        return None
    C = len(clusters)
    atom_idx = np.zeros((C, 4), np.int64)
    dists = np.zeros((C, 3), np.float64)
    mask = np.zeros((C, 3), np.float64)
    is_water = np.zeros((C,), bool)
    for r, (a, d, m) in enumerate(clusters):
        atom_idx[r] = a
        dists[r] = d
        mask[r] = m
        is_water[r] = r < top.water_count   # waters come first
    return atom_idx, dists, mask, int(mask.sum()), is_water


# local constraint pairs within a cluster (atom slots):
#   water:     (0=O, 1=H1, 2=H2):  (0,1), (0,2), (1,2)
#   H cluster: (0=X, 1..3=H):      (0,1), (0,2), (0,3)
_CON_WATER = np.array([[0, 1], [0, 2], [1, 2]], np.int64)
_CON_HX = np.array([[0, 1], [0, 2], [0, 3]], np.int64)


def count_constraints(top, cfg) -> int:
    built = _build_clusters(top)
    if built is None or cfg.hydrogen_constraint.kind == "flexible":
        # water stays rigid under flexible X-H (OPC is a rigid model)
        return 3 * top.water_count if top.water_count > 0 else 0
    return built[3]


def solve3(A, b, mask):
    """Masked analytic 3x3 solve (Cramer); inactive rows -> identity."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    m2 = mask[:, :, None] * mask[:, None, :]
    A = A * m2 + eye[None] * (1.0 - mask)[:, None, :] * eye[None]
    a00, a01, a02 = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    a10, a11, a12 = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    a20, a21, a22 = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.sign(det) * 1e-12 + (det == 0), det)
    bm = b * mask
    b0, b1, b2 = bm[:, 0], bm[:, 1], bm[:, 2]
    x0 = (b0 * c00 + b1 * (a02 * a21 - a01 * a22)
          + b2 * (a01 * a12 - a02 * a11)) * inv_det
    x1 = (b0 * c01 + b1 * (a00 * a22 - a02 * a20)
          + b2 * (a02 * a10 - a00 * a12)) * inv_det
    x2 = (b0 * c02 + b1 * (a01 * a20 - a00 * a21)
          + b2 * (a00 * a11 - a01 * a10)) * inv_det
    return torch.stack([x0, x1, x2], dim=-1) * mask


def make_constraint_fns(top, cfg, box):
    """(constrain_positions(x_new, x_ref), constrain_velocities(v, x),
    n_constraints); (None, None, 0) without constraints. The tables live
    on the device of `top`."""
    built = _build_clusters(top)
    if built is None:
        return None, None, 0
    atom_idx_np, dists_np, mask_np, n_con, is_water_np = built
    if cfg.hydrogen_constraint.kind == "flexible":
        keep = is_water_np
        if not keep.any():
            return None, None, 0
        atom_idx_np, dists_np = atom_idx_np[keep], dists_np[keep]
        mask_np, is_water_np = mask_np[keep], is_water_np[keep]
        n_con = int(mask_np.sum())

    dev = top.masses.device
    f32 = dict(dtype=top.masses.dtype, device=dev)
    atom_idx = torch.as_tensor(np.where(atom_idx_np < 0, 0, atom_idx_np),
                               device=dev)
    flat_idx = atom_idx.reshape(-1)
    slot_valid_np = (atom_idx_np >= 0).astype(np.float64)
    slot_valid = torch.as_tensor(slot_valid_np, **f32)[..., None]
    dists2 = torch.as_tensor(dists_np ** 2, **f32)
    cmask = torch.as_tensor(mask_np, **f32)
    con = torch.as_tensor(np.where(is_water_np[:, None, None],
                                   _CON_WATER[None], _CON_HX[None]),
                          device=dev)                     # [C, 3, 2]
    masses_np = _np(top.masses).astype(np.float64)
    inv_m = torch.as_tensor(
        (1.0 / np.maximum(masses_np[atom_idx_np.clip(0)], 1e-9))
        * slot_valid_np, **f32)                           # [C, 4]
    n_iters = (max(cfg.hydrogen_constraint.iters * 4, 8)
               if cfg.hydrogen_constraint.kind == "linear" else 8)
    ia = con[:, :, 0][:, :, None].expand(-1, -1, 3)       # [C, 3, 3]
    ib = con[:, :, 1][:, :, None].expand(-1, -1, 3)
    ik, jk = con[:, :, 0], con[:, :, 1]

    def cluster_vectors(p):
        """r_k = p[a_k] - p[b_k] for the 3 local constraints; p [C,4,3]."""
        return torch.gather(p, 1, ia) - torch.gather(p, 1, ib)

    # coupling c_kl: how lambda_l (along r_l0) moves r_k
    def dm(s1, s2, m_of):
        return (s1[:, :, None] == s2[:, None, :]).to(m_of.dtype) \
            * m_of[:, :, None]

    m_ik = torch.gather(inv_m, 1, ik)
    m_jk = torch.gather(inv_m, 1, jk)
    c_kl = (dm(ik, ik, m_ik) - dm(ik, jk, m_ik)
            - dm(jk, ik, m_jk) + dm(jk, jk, m_jk))        # [C, 3, 3]
    slots = torch.arange(4, device=dev)[None, :]
    onehot_a = [(slots == ik[:, k:k + 1])[..., None] for k in range(3)]
    onehot_b = [(slots == jk[:, k:k + 1])[..., None] for k in range(3)]
    m_a = [torch.gather(inv_m, 1, ik[:, k:k + 1]) for k in range(3)]
    m_b = [torch.gather(inv_m, 1, jk[:, k:k + 1]) for k in range(3)]

    def apply_lambda(p, lam, r0):
        """p[a_k] += lam_k r0_k / m_a; p[b_k] -= lam_k r0_k / m_b."""
        upd = torch.zeros_like(p)
        for k in range(3):
            d = lam[:, k, None] * r0[:, k, :]             # [C, 3]
            upd = (upd + onehot_a[k] * (d * m_a[k])[:, None, :]
                   + onehot_b[k] * (-d * m_b[k])[:, None, :])
        return p + upd

    def constrain_positions(x_new, x_ref):
        p_new = x_new[atom_idx]                           # [C, 4, 3]
        r0 = minimum_image(cluster_vectors(x_ref[atom_idx]), box)
        p = p_new
        for _ in range(n_iters):
            r = minimum_image(cluster_vectors(p), box)
            A = 2.0 * c_kl * torch.einsum("cki,cli->ckl", r, r0)
            b = dists2 - torch.sum(r * r, dim=-1)
            p = apply_lambda(p, solve3(A, b, cmask), r0)
        delta = (p - p_new) * slot_valid
        return x_new.index_add(0, flat_idx, delta.reshape(-1, 3))

    def constrain_velocities(v, x):
        vv = v[atom_idx]
        r = minimum_image(cluster_vectors(x[atom_idx]), box)
        rv = cluster_vectors(vv)                          # relative velocities
        A = c_kl * torch.einsum("cki,cli->ckl", r, r)
        b = -torch.sum(r * rv, dim=-1)
        vv2 = apply_lambda(vv, solve3(A, b, cmask), r)
        delta = (vv2 - vv) * slot_valid
        return v.index_add(0, flat_idx, delta.reshape(-1, 3))

    return constrain_positions, constrain_velocities, n_con
