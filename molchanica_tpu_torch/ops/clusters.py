"""Cluster-pair direct space (port of molchanica_tpu.ops.clusters), MdSim's
default backend for periodic systems.

Atoms are Morton-sorted into compact clusters of CL = 8; at each rebuild
an exact cluster-pair list [NC, M] is made (bounding-sphere candidates
refined by the 8 x 8 atom distances against rc + skin). A force
evaluation gathers each cluster's M neighbour clusters and runs dense
[8, M x 8] pair tiles, so the pair count tracks the true neighbour count.
The per-pair arithmetic is the cell-grid kernel's (A&S erfc, softcore LJ,
the LJ clip), so the exclusion subtraction of pme_rest cancels.

Plain torch on tensors that follow the inputs' dtype. Both loops stay
blocked as in the reference: the refinement in [blk, blk, 8, 8, 3] tiles
of ~160 clusters, the force in 16 blocks of [NC / 16, M, 8, 8] pair
slots; at config 3 (NC = 3,136, M = 288) one force block is 3.6 M slots
and its temporaries a few hundred MB. Sorts are stable (argsort(stable=
True)), so `order` and the list equal the reference's where the Morton
codes tie.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..constants import COULOMB_CONST
from .direct_force import LJ_CLIP, SOFTCORE_ALPHA, erfc_approx
from .pbc import minimum_image

CL = 8  # atoms per cluster
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


@dataclass(frozen=True)
class ClusterPlan:
    n_atoms: int          # padded atom count (multiple of CL)
    n_clusters: int
    m_neighbors: int      # pair-list width (padded)
    cutoff: float
    skin: float
    fine_cells: Tuple[int, int, int]


def plan_clusters(box_extent, cutoff: float, n_atoms_real: int,
                  n_atoms_pad: int, skin: float = 0.6,
                  density: float = None, m_scale: float = 1.0) -> ClusterPlan:
    """List width M from the atoms expected within rc + skin + twice a
    cluster's radius (8 Morton-sorted atoms occupy ~CL / rho), x 1.3
    x m_scale, rounded up to 16 (at least 32); Morton cells of ~2.8 A."""
    box = np.asarray(box_extent, np.float64)
    rho = density or max(n_atoms_real / float(np.prod(box)), 0.02)
    r_cl = 0.7 * (CL / rho) ** (1.0 / 3.0)
    r_eff = cutoff + skin + 2.0 * r_cl
    per_atom = 4.0 / 3.0 * math.pi * r_eff ** 3 * rho
    m = int(math.ceil(per_atom / CL * 1.3 * m_scale / 16.0)) * 16
    m = max(m, 32)
    nc_fine = tuple(int(v) for v in np.maximum((box / 2.8).astype(int), 1))
    return ClusterPlan(
        n_atoms=n_atoms_pad, n_clusters=n_atoms_pad // CL, m_neighbors=m,
        cutoff=cutoff, skin=skin, fine_cells=nc_fine)


def _morton(ci, cj, ck):
    """Interleave 10 bits per axis into a 30-bit Morton code."""
    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(ci) | (spread(cj) << 1) | (spread(ck) << 2)


def make_cluster_rebuild_fn(plan: ClusterPlan, top):
    """rebuild(x, box) -> (order [N] int64, nbr [NC, M] int64 (-1 pad),
    overflow int64): order is the atom of each sorted slot (padding atoms
    sort last and fill the trailing clusters); overflow is how far the
    longest row exceeds M (0 when the list holds)."""
    ncl = plan.n_clusters
    m_max = plan.m_neighbors
    fx, fy, fz = plan.fine_cells
    rc_list = plan.cutoff + plan.skin
    rl2 = rc_list * rc_list
    atom_mask = top.atom_mask
    n_blk = max(1, -(-ncl // 160))
    blk = -(-ncl // n_blk)
    pad_c = blk * n_blk - ncl

    def rebuild(x, box):
        dev = x.device
        u = x / box
        u = u - torch.floor(u)
        ci = torch.clamp_max((u[:, 0] * fx).to(torch.int64), fx - 1)
        cj = torch.clamp_max((u[:, 1] * fy).to(torch.int64), fy - 1)
        ck = torch.clamp_max((u[:, 2] * fz).to(torch.int64), fz - 1)
        code = _morton(ci, cj, ck)
        code = torch.where(atom_mask > 0, code,
                           torch.full_like(code, 0x7FFFFFFF))
        order = torch.argsort(code, stable=True)
        xs = x[order]
        xs = xs - box * torch.floor(xs / box)
        xc = xs.reshape(ncl, CL, 3)
        valid = (atom_mask[order] > 0).reshape(ncl, CL)
        any_valid = valid.any(dim=1)
        # centres (masked mean about the first atom, minimum image within
        # the compact cluster) and radii
        ref = xc[:, 0:1, :]
        rel = minimum_image(xc - ref, box)
        w = valid[..., None].to(xs.dtype)
        cnt = torch.clamp_min(w.sum(dim=1), 1.0)
        center_rel = (rel * w).sum(dim=1) / cnt
        center = ref[:, 0, :] + center_rel
        zero = torch.zeros((), dtype=xs.dtype, device=dev)
        radius = torch.sqrt(torch.amax(torch.where(
            valid, torch.sum((rel - center_rel[:, None, :]) ** 2, dim=-1),
            zero), dim=1))
        d = minimum_image(center[:, None, :] - center[None, :, :], box)
        cd = torch.sqrt(torch.sum(d * d, dim=-1))
        cand = ((cd < rc_list + radius[:, None] + radius[None, :])
                & any_valid[:, None] & any_valid[None, :])
        # exact refinement in [blk, blk, CL, CL, 3] tiles: does any atom
        # pair of the two clusters lie within rc + skin?
        xc_p = torch.cat([xc, torch.full((pad_c, CL, 3), 1e6,
                                         dtype=xc.dtype, device=dev)])
        v_p = torch.cat([valid, torch.zeros((pad_c, CL), dtype=torch.bool,
                                            device=dev)])
        hits = torch.zeros((blk * n_blk, blk * n_blk), dtype=torch.bool,
                           device=dev)
        for bi in range(n_blk):
            si = bi * blk
            xi, vi = xc_p[si:si + blk], v_p[si:si + blk]
            for bj in range(n_blk):
                sj = bj * blk
                xj, vj = xc_p[sj:sj + blk], v_p[sj:sj + blk]
                dd = minimum_image(
                    xi[:, None, :, None, :] - xj[None, :, None, :, :], box)
                r2 = torch.sum(dd * dd, dim=-1)
                ok = ((r2 < rl2) & vi[:, None, :, None]
                      & vj[None, :, None, :])
                hits[si:si + blk, sj:sj + blk] = ok.any(dim=3).any(dim=2)
        pairs = hits[:ncl, :ncl] & cand
        # compact each row's neighbours into [NC, M], in cluster order
        counts = pairs.sum(dim=1)
        overflow = torch.clamp_min(counts.max() - m_max, 0)
        iota = torch.arange(ncl, device=dev)
        key = torch.where(pairs, 0, 1) * ncl + iota[None, :]
        m_eff = min(m_max, ncl)
        nbr_sorted = torch.argsort(key, dim=1, stable=True)[:, :m_eff]
        in_range = iota[None, :m_eff] < counts[:, None]
        nbr = torch.where(in_range, nbr_sorted,
                          torch.full_like(nbr_sorted, -1))
        if m_eff < m_max:
            nbr = torch.cat([nbr, torch.full((ncl, m_max - m_eff), -1,
                                             dtype=nbr.dtype, device=dev)],
                            dim=1)
        return order, nbr, overflow

    return rebuild


def _pair_math(d, r2, pi, pj, ok, couple, beta, mags):
    """Pair math over one block, in the reference's op order. Returns
    (coeff = dV/dr2 masked, e_lj, e_c masked, mag): mag, with `mags`, is
    |LJ term| + |Coulomb term| of dV/dr2 (the scale that
    ops/direct_force.py's plain version reports)."""
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    r2s = torch.clamp_min(r2, 1e-4)
    inv_r2 = 1.0 / r2s
    qi = pi[:, None, :, None, 0]
    qj = pj[:, :, None, :, 0]
    sig = 0.5 * (pi[:, None, :, None, 1] + pj[:, :, None, :, 1])
    eps4 = 4.0 * torch.sqrt(pi[:, None, :, None, 2] * pj[:, :, None, :, 2])
    ca = pi[:, None, :, None, 3]
    cb = pj[:, :, None, :, 3]
    is_alch = ca + cb - 2.0 * ca * cb
    cpl = 1.0 - is_alch * (1.0 - couple)
    a_sc = SOFTCORE_ALPHA * (1.0 - cpl)
    s2 = sig * sig * inv_r2
    s6 = s2 * s2 * s2
    inv_den = 1.0 / (a_sc * s6 + 1.0)
    lj_inv = s6 * inv_den
    e_lj_raw = eps4 * cpl * (lj_inv * lj_inv - lj_inv)
    e_lj = torch.clamp(e_lj_raw, -LJ_CLIP, LJ_CLIP)
    unclipped = torch.abs(e_lj_raw) < LJ_CLIP
    dlj = eps4 * cpl * (2.0 * lj_inv - 1.0) * (inv_den * inv_den) \
        * (-3.0 * s6 * inv_r2)
    dlj = torch.where(unclipped, dlj, zero)
    r = torch.sqrt(r2s)
    inv_r = 1.0 / r
    erfc_v, expv = erfc_approx(beta * r)
    kqq = COULOMB_CONST * qi * qj * cpl
    e_c = kqq * erfc_v * inv_r
    dc = -0.5 * kqq * inv_r2 * (erfc_v * inv_r
                                + _TWO_OVER_SQRT_PI * beta * expv)
    coeff = torch.where(ok, dlj + dc, zero)
    mag = None
    if mags:
        lj_mag = torch.where(
            unclipped, torch.abs(eps4 * cpl) * (2.0 * lj_inv + 1.0)
            * (inv_den * inv_den) * (3.0 * s6 * inv_r2), zero)
        mag = torch.where(ok, lj_mag + torch.abs(dc), zero)
    return (coeff, torch.where(ok, e_lj, zero), torch.where(ok, e_c, zero),
            mag)


def make_cluster_direct_force_fn(top, cfg, plan: ClusterPlan):
    """direct(x, box, couple, beta, order, nbr, want_force=True,
    stats=None) -> (F [N, 3] or None, e_lj, e_c, 0).

    Every pair appears from both of its clusters (and the self-cluster
    tile holds each of its pairs twice), so the energies are half sums;
    forces are center-side. The energies are differentiable in x and the
    box (the barostat's dE/ds); `want_force=False` skips the forces. A
    `stats` dict receives "f_abs" [N], each atom's sum over its pairs of
    2 r (|LJ term| + |Coulomb term|) of dV/dr2, and "e_abs_lj" /
    "e_abs_c", the half sums of |e_lj| and |e_c|: the float32 scales of
    the output (the excluded pairs that pme_rest subtracts again are in
    them)."""
    n = plan.n_atoms
    ncl = plan.n_clusters
    m_max = plan.m_neighbors
    rc2 = float(plan.cutoff) ** 2
    n_blk = 16
    blk = -(-ncl // n_blk)
    pad_c = blk * n_blk - ncl

    def direct(x, box, couple, beta, order, nbr, want_force=True,
               stats=None):
        dev, dt = x.device, x.dtype
        xs = x[order]
        xs = xs - box * torch.floor(xs / box)
        props = torch.stack([(top.charges * top.atom_mask)[order],
                             top.lj_sigma[order], top.lj_eps[order],
                             top.couple_mask[order], top.atom_mask[order]],
                            dim=1).to(dt)
        xc = xs.reshape(ncl, CL, 3)
        pc = props.reshape(ncl, CL, 5)
        xc_p = torch.cat([xc, torch.zeros((pad_c, CL, 3), dtype=dt,
                                          device=dev)])
        pc_p = torch.cat([pc, torch.zeros((pad_c, CL, 5), dtype=dt,
                                          device=dev)])
        nbr_p = torch.cat([nbr, torch.full((pad_c, m_max), -1,
                                           dtype=nbr.dtype, device=dev)])
        e_lj = torch.zeros((), dtype=dt, device=dev)
        e_c = torch.zeros_like(e_lj)
        f_parts, a_parts = [], []
        e_abs_lj = e_abs_c = 0.0
        for b in range(n_blk):
            s = b * blk
            xi, pi = xc_p[s:s + blk], pc_p[s:s + blk]
            nb = nbr_p[s:s + blk]
            nb_ok = nb >= 0
            nbc = torch.where(nb_ok, nb, torch.zeros_like(nb))
            xj = xc[nbc]                               # [blk, M, CL, 3]
            pj = pc[nbc]                               # [blk, M, CL, 5]
            d = minimum_image(
                xi[:, None, :, None, :] - xj[:, :, None, :, :], box)
            r2 = torch.sum(d * d, dim=-1)              # [blk, M, CLi, CLj]
            ok = ((r2 < rc2) & (r2 > 1e-9) & nb_ok[:, :, None, None]
                  & (pi[:, None, :, None, 4] > 0)
                  & (pj[:, :, None, :, 4] > 0))
            coeff, el, ec, mag = _pair_math(d, r2, pi, pj, ok, couple,
                                            beta, stats is not None)
            e_lj = e_lj + torch.sum(el)
            e_c = e_c + torch.sum(ec)
            if want_force:
                f_parts.append(-2.0 * torch.sum(
                    coeff.detach()[..., None] * d.detach(), dim=(1, 3)))
            if stats is not None:
                r = torch.sqrt(r2.detach())
                a_parts.append(torch.sum(2.0 * mag.detach() * r,
                                         dim=(1, 3)))
                e_abs_lj += 0.5 * float(torch.abs(el.detach()).sum())
                e_abs_c += 0.5 * float(torch.abs(ec.detach()).sum())
        f_atoms = None
        if want_force:
            # unsort: sorted slot s holds atom order[s]
            f_atoms = torch.zeros((n, 3), dtype=dt, device=dev)
            f_atoms[order] = torch.cat(f_parts)[:ncl].reshape(n, 3)
            f_atoms = f_atoms * top.atom_mask.to(dt)[:, None]
        if stats is not None:
            a = torch.zeros((n,), dtype=dt, device=dev)
            a[order] = torch.cat(a_parts)[:ncl].reshape(n)
            stats.update(f_abs=a * top.atom_mask.to(dt), e_abs_lj=e_abs_lj,
                         e_abs_c=e_abs_c)
        return (f_atoms, 0.5 * e_lj, 0.5 * e_c,
                torch.zeros((), dtype=torch.int64, device=dev))

    return direct
