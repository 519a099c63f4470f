"""Cluster-pair direct space (port of molchanica_tpu.ops.clusters), MdSim's
default backend for periodic systems.

Atoms are Morton-sorted into compact clusters of CL = 8; at each rebuild
an exact cluster-pair list [NC, M] is made (bounding-sphere candidates
refined by the 8 x 8 atom distances against rc + skin). A force
evaluation gathers each cluster's M neighbour clusters and runs dense
[8, M x 8] pair tiles, so the pair count tracks the true neighbour count.
The per-pair arithmetic is the cell-grid kernel's (A&S erfc, softcore LJ,
the LJ clip); excluded and 1-4 pairs are left out: the rebuild flags the
list entries whose two clusters hold such a pair (one byte per entry), and
the force looks the pairs of a flagged entry up in the topology's exclusion
table (ops/exclusions.py) by their sites.

The force runs as the hand-written CUDA kernel csrc/cluster_force.cu for
CUDA tensors (`cluster_force_cuda`, one launch for every replica) and as
its plain torch twin (`make_cluster_direct_plain`) for CPU tensors; the
twin is also the differentiable energy and the `stats` that callers take
by name. Plain torch elsewhere, on tensors that follow the inputs' dtype.
Both plain loops stay blocked as in the reference: the refinement in
[blk, blk, 8, 8, 3] tiles of ~160 clusters, the force in 16 blocks of
[NC / 16, M, 8, 8] pair slots; at config 3 (NC = 3,136, M = 288) one
force block is 3.6 M slots and its temporaries a few hundred MB. Sorts are
stable (argsort(stable=True)), so `order` and the list equal the
reference's where the Morton codes tie, and each row of the list holds
its listed clusters before its -1 padding, which the kernel's early stop
relies on.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch.func import vmap

from .. import tracing
from ..constants import COULOMB_CONST
from .direct_force import LJ_CLIP, SOFTCORE_ALPHA, erfc_approx
from .exclusions import Exclusions
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


def make_cluster_rebuild_fn(plan: ClusterPlan, top, excl: Exclusions):
    """rebuild(x, box) -> (order [N] int64, nbr [NC, M] int64 (-1 pad),
    flags [NC, M] uint8, overflow int64): order is the atom of each sorted
    slot (padding atoms sort last and fill the trailing clusters);
    flags[c, k] is 1 where cluster c and cluster nbr[c, k] hold a pair of
    `excl` (the topology's exclusion table), 0 elsewhere and on padding;
    overflow is how far the longest row exceeds M (0 when the list
    holds)."""
    ncl = plan.n_clusters
    m_max = plan.m_neighbors
    fx, fy, fz = plan.fine_cells
    rc_list = plan.cutoff + plan.skin
    rl2 = rc_list * rc_list
    atom_mask = top.atom_mask
    n_blk = max(1, -(-ncl // 160))
    blk = -(-ncl // n_blk)
    pad_c = blk * n_blk - ncl
    # each excluded pair from both of its atoms' clusters: [2, 2P] sites
    ep = excl.pairs.to(atom_mask.device)
    pair_sites = torch.stack([torch.cat([ep[:, 0], ep[:, 1]]),
                              torch.cat([ep[:, 1], ep[:, 0]])])

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
        # the tiles are joined out of place, so that torch.func.vmap can
        # batch the rebuild over replicas (parallel/replicas.py)
        rows = []
        for bi in range(n_blk):
            si = bi * blk
            xi, vi = xc_p[si:si + blk], v_p[si:si + blk]
            row = []
            for bj in range(n_blk):
                sj = bj * blk
                xj, vj = xc_p[sj:sj + blk], v_p[sj:sj + blk]
                dd = minimum_image(
                    xi[:, None, :, None, :] - xj[None, :, None, :, :], box)
                r2 = torch.sum(dd * dd, dim=-1)
                ok = ((r2 < rl2) & vi[:, None, :, None]
                      & vj[None, :, None, :])
                row.append(ok.any(dim=3).any(dim=2))
            rows.append(torch.cat(row, dim=1))
        hits = torch.cat(rows, dim=0)
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
        # the cluster pairs that hold an excluded pair, read at the list's
        # entries (every value written is True, so repeats agree)
        cl = torch.argsort(order)[pair_sites] // CL        # [2, 2P]
        held = torch.zeros(ncl * ncl, dtype=torch.bool, device=dev).index_put(
            (cl[0] * ncl + cl[1],), torch.ones_like(cl[0], dtype=torch.bool))
        flags = (torch.gather(held.reshape(ncl, ncl), 1, nbr_sorted)
                 & in_range).to(torch.uint8)
        if m_eff < m_max:
            pad = (ncl, m_max - m_eff)
            nbr = torch.cat([nbr, torch.full(pad, -1, dtype=nbr.dtype,
                                             device=dev)], dim=1)
            flags = torch.cat([flags, torch.zeros(pad, dtype=flags.dtype,
                                                  device=dev)], dim=1)
        return order, nbr, flags, overflow

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


def make_cluster_direct_plain(top, cfg, plan: ClusterPlan,
                              excl: Exclusions):
    """The plain torch twin of the cluster force kernel: plain(x, box,
    couple, beta, order, nbr, flags, want_force=True, stats=None) -> (F
    [N, 3] or None, e_lj, e_c, 0), without the atom pairs of `excl` (the
    topology's exclusion table), looked up in the entries that the
    rebuild's `flags` mark.

    Every pair appears from both of its clusters (and the self-cluster
    tile holds each of its pairs twice), so the energies are half sums;
    forces are center-side. The energies are differentiable in x and the
    box (the barostat's dE/ds); `want_force=False` skips the forces. A
    `stats` dict receives "f_abs" [N], each atom's sum over its pairs of
    2 r (|LJ term| + |Coulomb term|) of dV/dr2, and "e_abs_lj" /
    "e_abs_c", the half sums of |e_lj| and |e_c|: the float32 scales of
    the output.

    x may carry a leading replica axis ([R, N, 3], with order [R, N], nbr
    and flags [R, NC, M] and couple [R] or a scalar): the replicas then run
    under torch.func.vmap, F is [R, N, 3] and the energies [R]; stats take
    one replica."""
    one = _plain_one(top, plan, excl)
    batched = {w: vmap(functools.partial(_drop_force, one, w),
                       in_dims=(0, None, 0, None, 0, 0, 0))
               for w in (False, True)}

    def plain(x, box, couple, beta, order, nbr, flags, want_force=True,
              stats=None):
        if x.dim() == 2:
            return one(x, box, couple, beta, order, nbr, flags, want_force,
                       stats)
        if stats is not None:
            raise ValueError("cluster_direct_plain: stats take one replica")
        couple = torch.as_tensor(couple, dtype=x.dtype,
                                 device=x.device).expand(x.shape[0])
        out = batched[want_force](x, box, couple, beta, order, nbr, flags)
        return (out if want_force else (None,) + out) + (
            torch.zeros(x.shape[:1], dtype=torch.int64, device=x.device),)

    return plain


def _drop_force(one, want_force, x, box, couple, beta, order, nbr, flags):
    """one replica's (F, e_lj, e_c), or (e_lj, e_c): vmap returns no
    None."""
    f, e_lj, e_c, _ = one(x, box, couple, beta, order, nbr, flags,
                          want_force, None)
    return (f, e_lj, e_c) if want_force else (e_lj, e_c)


def _plain_one(top, plan: ClusterPlan, excl: Exclusions):
    n = plan.n_atoms
    ncl = plan.n_clusters
    m_max = plan.m_neighbors
    rc2 = float(plan.cutoff) ** 2
    n_blk = 16
    blk = -(-ncl // n_blk)
    pad_c = blk * n_blk - ncl
    excl = excl.to(top.atom_mask.device)

    def one(x, box, couple, beta, order, nbr, flags, want_force, stats):
        dev, dt = x.device, x.dtype
        xs = x[order]
        xs = xs - box * torch.floor(xs / box)
        props = direct_rows(top)[order].to(dt)
        xc = xs.reshape(ncl, CL, 3)
        pc = props.reshape(ncl, CL, 5)
        xc_p = torch.cat([xc, torch.zeros((pad_c, CL, 3), dtype=dt,
                                          device=dev)])
        pc_p = torch.cat([pc, torch.zeros((pad_c, CL, 5), dtype=dt,
                                          device=dev)])
        nbr_p = torch.cat([nbr, torch.full((pad_c, m_max), -1,
                                           dtype=nbr.dtype, device=dev)])
        flags_p = torch.cat([flags, torch.zeros((pad_c, m_max),
                                                dtype=flags.dtype,
                                                device=dev)])
        # each slot's site (-1 on the padding clusters: excluded from none)
        site = order.reshape(ncl, CL)
        site_p = torch.cat([site, torch.full((pad_c, CL), -1,
                                             dtype=site.dtype, device=dev)])
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
            ex = excl.excluded(site_p[s:s + blk, None, :, None],
                               site[nbc][:, :, None, :])
            ok = ((r2 < rc2) & (r2 > 1e-9) & nb_ok[:, :, None, None]
                  & (pi[:, None, :, None, 4] > 0)
                  & (pj[:, :, None, :, 4] > 0)
                  & ~((flags_p[s:s + blk, :, None, None] > 0) & ex))
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
        # unsort: sorted slot s holds atom order[s] (out of place, for vmap)
        if want_force:
            f_atoms = torch.zeros((n, 3), dtype=dt, device=dev).index_put(
                (order,), torch.cat(f_parts)[:ncl].reshape(n, 3))
            f_atoms = f_atoms * top.atom_mask.to(dt)[:, None]
        if stats is not None:
            a = torch.zeros((n,), dtype=dt, device=dev).index_put(
                (order,), torch.cat(a_parts)[:ncl].reshape(n))
            stats.update(f_abs=a * top.atom_mask.to(dt), e_abs_lj=e_abs_lj,
                         e_abs_c=e_abs_c)
        return (f_atoms, 0.5 * e_lj, 0.5 * e_c,
                torch.zeros((), dtype=torch.int64, device=dev))

    return one


def direct_rows(top):
    """[N, 5] per-atom rows of the kernel: q * atom_mask, sigma, eps,
    couple mask, atom mask."""
    return torch.stack([top.charges * top.atom_mask, top.lj_sigma,
                        top.lj_eps, top.couple_mask, top.atom_mask],
                       dim=1).contiguous()


def make_cluster_direct_force_fn(top, cfg, plan: ClusterPlan,
                                 excl: Exclusions):
    """direct(x, box, couple, beta, order, nbr, flags, want_force=True,
    stats=None) -> (F [N, 3] or None, e_lj, e_c, 0): MdSim's cluster force,
    without the atom pairs of `excl` (the topology's exclusion table) in
    the entries that the rebuild's `flags` mark.

    CUDA tensors launch the hand-written kernel (csrc/cluster_force.cu,
    `cluster_force_cuda`), one launch whatever the replica axis; CPU
    tensors take the plain twin, `direct.plain` (make_cluster_direct_plain),
    which callers that need a differentiable energy or `stats` call by
    name on either device. Both take a leading replica axis on x, order,
    nbr, flags and couple (F [R, N, 3], energies [R])."""
    plain = make_cluster_direct_plain(top, cfg, plan, excl)
    rc2 = float(plan.cutoff) ** 2
    rows = direct_rows(top)
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)

    def direct(x, box, couple, beta, order, nbr, flags, want_force=True,
               stats=None):
        if x.device.type != "cuda":
            return plain(x, box, couple, beta, order, nbr, flags, want_force,
                         stats)
        if stats is not None:
            raise ValueError("cluster force: stats come from the plain "
                             "twin (direct.plain)")
        f, e = cluster_force_cuda(plan, x, box, couple, beta, order, nbr,
                                  flags, excl.to(x.device),
                                  rows.to(x.device, x.dtype), rc2,
                                  want_force)
        return f, e[..., 0], e[..., 1], zero

    direct.plain = plain
    return direct


def cluster_force_cuda(plan: ClusterPlan, x, box, couple, beta, order, nbr,
                       flags, excl: Exclusions, rows, rc2, want_force=True):
    """Launch csrc/cluster_force.cu on the current stream: (F [N, 3] or
    None, e [2] = the half sums (e_lj, e_c)), in x's dtype (float32 or
    float64), without the atom pairs of `excl` (an ops/exclusions.py table
    on the card) in the entries that `flags` (the rebuild's) mark.
    With a leading replica axis (x [R, N, 3], order [R, N], nbr and flags
    [R, NC, M], couple [R] or a scalar) one launch runs the R replicas and
    returns [R, N, 3] and [R, 2]; x's replicas may lie any stride apart
    (its rows contiguous). rows is `direct_rows(top)` in x's dtype;
    nbr's rows must be compacted (the rebuild's are). With couple, beta and
    box on the card the launch copies nothing from the host, so it can be
    captured in a CUDA graph; a Python float is copied at every call. The
    tracing counter "cluster_force" counts each launch. The kernel gives no
    gradient: an input that requires one under autograd raises."""
    import ctypes

    from ..cuda_build import load_library

    dev, dt = x.device, x.dtype
    n, ncl, m = plan.n_atoms, plan.n_clusters, plan.m_neighbors
    lead = tuple(x.shape[:-2])
    R = x.shape[0] if lead else 1
    couple, beta, box = (torch.as_tensor(v, dtype=dt, device=dev)
                         for v in (couple, beta, box))
    if len(lead) > 1 or x.shape != lead + (n, 3) \
            or order.shape != lead + (n,) or nbr.shape != lead + (ncl, m) \
            or flags.shape != nbr.shape or rows.shape != (n, 5) \
            or excl.bits.shape[0] != n or not 0 < R < 65536 \
            or couple.shape not in ((), (R,)) or beta.shape != () \
            or box.shape != (3,):
        raise ValueError(
            f"cluster_force: shapes x {tuple(x.shape)}, order "
            f"{tuple(order.shape)}, nbr {tuple(nbr.shape)}, flags "
            f"{tuple(flags.shape)}, exclusion table "
            f"{tuple(excl.bits.shape)}, rows "
            f"{tuple(rows.shape)}, couple {tuple(couple.shape)}, beta "
            f"{tuple(beta.shape)}, box {tuple(box.shape)}: want [R,] [{n}, "
            f"3], [R,] [{n}], [R,] [{ncl}, {m}] twice, [{n}, words], "
            f"[{n}, 5], [R] or a scalar, a scalar, [3]; R < 65,536")
    tensors = (("x", x, dt), ("rows", rows, dt), ("order", order,
               torch.int64), ("nbr", nbr, torch.int64),
               ("flags", flags, torch.uint8),
               ("exclusion table", excl.bits, torch.int32))
    if dt not in (torch.float32, torch.float64) \
            or any(t.dtype != want for _, t, want in tensors):
        raise ValueError(f"cluster_force: dtypes x {dt}, rows {rows.dtype},"
                         f" order {order.dtype}, nbr {nbr.dtype}, flags "
                         f"{flags.dtype}, exclusion table "
                         f"{excl.bits.dtype}: want float32 or float64, the "
                         f"same, int64, int64, uint8, int32")
    tensors += (("couple", couple, dt), ("beta", beta, dt),
                ("box", box, dt))
    # x's replicas may lie apart (vmap's outputs pad them), its rows not
    if x.stride()[-2:] != (3, 1) or not all(
            t.is_contiguous() for _, t, _ in tensors[1:]):
        raise ValueError("cluster_force: x's rows and every other tensor "
                         "must be contiguous")
    if dev.type != "cuda" \
            or any(t.device != dev for _, t, _ in tensors):
        raise ValueError(f"cluster_force: every tensor must lie on one "
                         f"CUDA device, x lies on {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, box, couple, beta, rows)):
        raise ValueError("cluster_force: the kernel gives no gradient; "
                         "call the plain twin for a differentiable energy")
    lib = load_library()
    f = torch.empty(lead + (n, 3), dtype=dt, device=dev) \
        if want_force else None
    e_part = torch.empty((R * ncl * 2,), dtype=torch.float64, device=dev)
    e = torch.empty(lead + (2,), dtype=dt, device=dev)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    err = lib.cluster_force_launch(
        int(dt == torch.float64), int(want_force), R, n, ncl, m,
        int(couple.dim() == 1), x.stride(0) if lead else 3 * n,
        ctypes.c_double(rc2), ptr(x), ptr(order),
        ptr(nbr), ptr(flags), ptr(excl.bits), excl.words, ptr(rows),
        ptr(couple), ptr(beta), ptr(box),
        ptr(f), ptr(e_part), ptr(e),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"cluster_force kernel launch failed: CUDA error "
                           f"{err}")
    tracing.count("cluster_force")
    return f, e
