"""Column-pair direct-space LJ + Ewald Coulomb: the plan, the rebuild
tables, the pair-list twin used for exclusion subtraction, and the
direct-space kernel (port of molchanica_tpu.ops.pallas.colpair).

The state lives sorted by (xy column, z). Atoms are binned into xy columns
at least rc + skin wide and z-ordered within each column; every column run
is padded to a multiple of ICL = 64 slots, so each 64-slot i-cluster is
column-pure and its j-neighbourhood is a set of slot ranges in the 3x3
column window. The window table lists, per cluster, entries (lo, hi,
code): a [lo, hi) slot range plus the periodic x/y/z shift baked into
`code` (2 bits per axis, value s + 1 for s in {-1, 0, 1} box lengths), so
the kernel needs no per-pair minimum image. Per-slice tables hold up to
`per_slice_k` entries, each inside one 128-slot slice; range tables
(`per_slice_k=0`) hold up to `plan.w_max` whole ranges, and the kernel
walks the slices of each. Triangular tables evaluate every unordered pair
once and send the reaction force to j (Newton's third law); symmetric
tables evaluate every ordered pair from its i side and halve the
energies; cross tables pair a subset array with a master array.

`ColpairDirect` is the kernel: the hand-written CUDA kernel in
csrc/colpair.cu for CUDA tensors, and `colpair_plain` (the same function
in plain torch) for CPU tensors. Its shard variant (`local_shape`) runs
one block of clusters of a sorted state split over several processes
(parallel/spatial_colpair.py); its cross variant (`cross`) runs a solute
subset against the master array. `colpair_work` is a plain model of the
CUDA kernel's schedule (its work items, 32-slot j chunks and compacted
pair batches) for the tests and chip_smoke.py. `pairlist_colpair_energy`
evaluates the same pair math over an explicit pair list, so excluded
pairs that the kernel adds are subtracted to float32 roundoff.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import tracing

# Atoms per i-cluster.
ICL = 64
ZBITS = 14        # z quantization bits in the sort key
LANES = 128       # j slots per slice
PER_SLICE_K = 64  # window entries per cluster (doubled on overflow)
CHUNK_ELEMS = 1 << 25  # pair-tile elements per chunk of colpair_plain
# csrc/colpair.cu's schedule: a grid of (cluster, part) blocks of
# WORK_WARPS warps each; a cluster's window is cut into CHUNK-slot j chunks
CHUNK = 32
WORK_WARPS = 4
# blocks the grid is sized to reach: 8 per SM of an H100 SXM (132 SMs)
GRID_BLOCKS = 8 * 132
# pairs whose float32 r^2 lies within this of rc^2 (relative) may count on
# one side of the cutoff in one float32 evaluation and on the other side
# in another (an fma, or its absence, moves r^2 by an ulp)
NEAR_RC = 1e-6
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

# r^2 floor (A^2): closer pairs (mid-clash, or excluded intramolecular
# pairs) are evaluated at the clamped distance, in the kernel and in the
# subtraction path alike.
R2_MIN = 0.25
# Alchemical softcore constants (has_alch kernels and the pair-list path).
SC_ALPHA = 0.5
SC_SIG2_MIN = 9.0
# LJ C1 sigma clamp: s^2 = (sigma/r)^2 is capped smoothly at 1/SIG_CLAMP^2
# with a quadratic blend over [_S2_LO, _S2_HI], so a one-ulp disagreement
# in r^2 between the kernel and the subtraction path costs O(ulp) force
# instead of the full LJ wall.
SIG_CLAMP = 0.40
_S2_MAX = 1.0 / (SIG_CLAMP * SIG_CLAMP)
_S2_BLEND = 0.0625
_S2_LO = _S2_MAX * (1.0 - _S2_BLEND)
_S2_HI = _S2_MAX * (1.0 + _S2_BLEND)
_S2_W = _S2_HI - _S2_LO


def _s2_clamped(s2_raw):
    """C1 soft cap of s^2 at _S2_MAX: identity below _S2_LO, quadratic
    blend on [_S2_LO, _S2_HI], constant above. Returns (s2, d s2/d s2_raw).
    """
    u = torch.clamp(s2_raw - _S2_LO, 0.0, _S2_W)
    s2 = torch.clamp_max(s2_raw, _S2_HI) - u * u * (0.5 / _S2_W)
    gp = 1.0 - u * (1.0 / _S2_W)
    return s2, gp


def erfcx_cheb_coeffs(xmax: float, tol: float = 1e-6) -> np.ndarray:
    """Fit g(x) = erfc(x) exp(x^2) on [0, xmax] as a plain power series
    (Chebyshev-node least squares) at the lowest degree whose relative
    error is below `tol`."""
    from numpy.polynomial import chebyshev as C
    from scipy.special import erfc
    nodes = np.cos(np.pi * (np.arange(1024) + 0.5) / 1024)
    x = 0.5 * (nodes + 1.0) * xmax
    g = erfc(x) * np.exp(x * x)
    err = None
    for d in range(6, 17):
        cheb = C.Chebyshev.fit(x, g, d, domain=[0.0, xmax], w=1.0 / g)
        c = np.asarray(cheb.convert(kind=np.polynomial.Polynomial).coef,
                       np.float64)
        fit = np.polynomial.polynomial.polyval(x, c)
        err = float((np.abs(fit - g) / np.abs(g)).max())
        if err < tol:
            return c
    raise AssertionError(
        f"erfcx fit cannot reach tol {tol:.1e} on [0, {xmax:.3f}] "
        f"by degree 16 (last err {err:.2e})")


def coulomb_kpoly_coeffs(xmax: float, tol: float = 5e-6) -> np.ndarray:
    """Force-only Coulomb polynomial: K(x) = erfc(x)/2 + x e^{-x^2}/sqrt(pi)
    as a power series in t = 2x/xmax - 1, so dc = -kqq K(beta r)/r^3 is one
    Horner. Validated on the float32 Horner the kernel runs."""
    from numpy.polynomial import chebyshev as C
    from scipy.special import erfc
    nodes = np.cos(np.pi * (np.arange(1024) + 0.5) / 1024)
    x = 0.5 * (nodes + 1.0) * xmax
    k = 0.5 * erfc(x) + x * np.exp(-x * x) / np.sqrt(np.pi)
    t32 = (2.0 * x / xmax - 1.0).astype(np.float32)
    for d in range(8, 19):
        c = C.cheb2poly(C.Chebyshev.fit(x, k, d, domain=[0.0, xmax]).coef)
        g = np.full_like(t32, np.float32(c[-1]))
        for cv in c[-2::-1].astype(np.float32):
            g = g * t32 + cv
        if np.abs(g.astype(np.float64) - k).max() < tol:
            return np.asarray(c, np.float64)
    raise AssertionError(f"K-poly fit cannot reach {tol:.1e} by degree 18")


@dataclass(frozen=True)
class ColPlan:
    """Static geometry for the column sort and the window kernel."""
    nx: int
    ny: int
    wx: float                 # column width (A), from the plan-time box
    wy: float
    lz: float
    n_sorted: int             # padded sorted-slot count (multiple of 128)
    n_base: int               # base (original-order) atom count
    cutoff: float             # force cutoff rc (A)
    skin: float
    beta: float               # Ewald splitting parameter
    erfcx_coeffs: Tuple[float, ...]
    kpoly_coeffs: Tuple[float, ...] = ()
    kpoly_xmax: float = 0.0
    # rigid-solvent sites inherit their O's sort key, which places a key up
    # to r_blob from the site: window selection reaches rc + skin + r_blob
    r_blob: float = 0.0
    rings: int = 1
    offsets: Tuple[Tuple[int, int], ...] = tuple(
        (dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))

    @property
    def n_cols(self) -> int:
        return self.nx * self.ny

    @property
    def n_clusters(self) -> int:
        return self.n_sorted // ICL

    @property
    def rc_wb(self) -> float:
        return self.cutoff + self.skin + self.r_blob

    @property
    def w_max(self) -> int:
        """Range-table width: up to 3 z-ranges per in-disc column."""
        return 3 * len(self.offsets)


def plan_columns(box_extent, cutoff: float, beta: float, n_atoms_real: int,
                 n_base: int, skin: float = 1.2,
                 r_blob: float = 0.0) -> ColPlan:
    """Column grid for one ring (3x3 window): each column is at least
    rc + skin + 2 r_blob wide, so the window covers the cutoff sphere."""
    box = np.asarray(box_extent, np.float64)
    rcw = cutoff + skin + r_blob
    reach = rcw + r_blob
    nx = max(int(box[0] / reach), 1)
    ny = max(int(box[1] / reach), 1)
    if nx < 3 or ny < 3 or box[2] < 2 * rcw - 1e-9:
        raise ValueError(f"box {box} too small for colpair at cutoff "
                         f"{cutoff}")
    wx = float(box[0] / nx)
    wy = float(box[1] / ny)
    offs = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            gx = max(abs(dx) - 1, 0) * wx
            gy = max(abs(dy) - 1, 0) * wy
            if gx * gx + gy * gy < reach * reach:
                offs.append((dx, dy))
    # capacity: real atoms + per-column pad-to-ICL
    cap = n_atoms_real + ICL * nx * ny
    n_sorted = ((cap + 127) // 128) * 128
    # r2 is clamped to [R2_MIN, rc^2] before the erfc evaluation, so the
    # fit domain is exactly [0, beta rc]
    xmax = float(beta) * cutoff + 1e-3
    return ColPlan(nx=nx, ny=ny, wx=wx, wy=wy, lz=float(box[2]),
                   n_sorted=n_sorted, n_base=n_base,
                   cutoff=float(cutoff), skin=float(skin), beta=float(beta),
                   erfcx_coeffs=tuple(float(v)
                                      for v in erfcx_cheb_coeffs(xmax)),
                   kpoly_coeffs=tuple(float(v)
                                      for v in coulomb_kpoly_coeffs(xmax)),
                   kpoly_xmax=xmax, r_blob=float(r_blob), rings=1,
                   offsets=tuple(offs))


def _arange(n, device):
    return torch.arange(n, dtype=torch.int64, device=device)


def _round_up_icl(cnt):
    return ((cnt + ICL - 1) // ICL) * ICL


def _col_of(u, n):
    return torch.clamp_max((u * n).long(), n - 1)


def make_sort_fn(plan: ColPlan):
    """Per-site column sort: sort(x, box, atom_mask) -> (perm [S] base ids
    (n_base = dummy), key_sorted [S], col_start [n_cols+1], overflow).

    Every real site keys by its own (column, z-bin); pads sort to the end.
    The argsort is stable, so sites of equal key keep their input order.
    Slot S is a sink for the pads' writes and is cut off. The tables live
    on x's device."""
    nx, ny = plan.nx, plan.ny
    S = plan.n_sorted
    n_base = plan.n_base
    n_cols = plan.n_cols
    zmax = (1 << ZBITS) - 1

    def sort(x, box, atom_mask):
        dev = x.device
        u = x / box
        u = u - torch.floor(u)
        cx = _col_of(u[:, 0], nx)
        cy = _col_of(u[:, 1], ny)
        zb = _col_of(u[:, 2], zmax + 1)
        real = atom_mask > 0
        col = torch.where(real, cx * ny + cy, torch.full_like(cx, n_cols))
        key = (col << ZBITS) | torch.where(real, zb, torch.zeros_like(zb))
        order = torch.argsort(key, stable=True)
        col_sorted = col[order]
        # per-column runs among the real prefix, padded to ICL
        cs_real = torch.searchsorted(col_sorted.contiguous(),
                                     _arange(n_cols + 1, dev))
        pcnt = _round_up_icl(cs_real[1:] - cs_real[:-1])
        col_start = torch.cat([torch.zeros_like(pcnt[:1]),
                               torch.cumsum(pcnt, 0)])
        overflow = torch.clamp_min(col_start[-1] - S, 0)
        r = _arange(n_base, dev)
        c_of = torch.clamp(col_sorted, 0, n_cols - 1)
        valid = r < real.sum()
        slot = torch.where(valid, torch.clamp(
            col_start[c_of] + (r - cs_real[c_of]), 0, S - 1),
            torch.full_like(r, S))
        perm = torch.full((S + 1,), n_base, dtype=torch.int64, device=dev)
        perm[slot] = torch.where(valid, order, torch.full_like(order, n_base))
        perm = perm[:S]
        pad = n_cols << ZBITS
        key_sorted = torch.full((S + 1,), pad, dtype=torch.int64, device=dev)
        key_sorted[slot] = torch.where(valid, key[order],
                                       torch.full_like(key, pad))
        slot_col = torch.searchsorted(col_start[1:].contiguous(),
                                      _arange(S, dev), right=True)
        pad_key = (torch.clamp_max(slot_col, n_cols - 1) << ZBITS) | zmax
        key_sorted = torch.where(perm == n_base, pad_key, key_sorted[:S])
        return perm, key_sorted, col_start, overflow

    return sort


def make_anchor_sort_fn(plan: ColPlan, anchor_ids, sizes, atom_mask_base,
                        device=None):
    """Molecule-anchor column sort: argsort over anchors (one key per water
    block or free atom), then expand each anchor to `size` consecutive
    slots. Returns sort(x_base, box) -> (perm [S] base ids (n_base =
    dummy), key_sorted [S], col_start [n_cols+1], overflow). Its tables
    live on `device` (None means the CUDA card)."""
    from ..device import resolve_device

    device = resolve_device(device)
    nx, ny = plan.nx, plan.ny
    S = plan.n_sorted
    n_base = plan.n_base
    n_cols = plan.n_cols
    zmax = (1 << ZBITS) - 1
    aid_np = np.asarray(anchor_ids, np.int64)
    sz_np = np.asarray(sizes, np.int64)
    msk_np = np.asarray(atom_mask_base)[aid_np] > 0
    aid = torch.as_tensor(aid_np, device=device)
    sz = torch.as_tensor(np.where(msk_np, sz_np, 0), device=device)
    msk = torch.as_tensor(msk_np, device=device)
    max_sz = int(sz_np.max()) if sz_np.size else 1

    def sort(x_base, box):
        u = x_base[aid] / box
        u = u - torch.floor(u)
        cx = _col_of(u[:, 0], nx)
        cy = _col_of(u[:, 1], ny)
        zb = _col_of(u[:, 2], zmax + 1)
        col = torch.where(msk, cx * ny + cy, torch.full_like(cx, n_cols))
        key = (col << ZBITS) | torch.where(msk, zb, torch.zeros_like(zb))
        order = torch.argsort(key, stable=True)
        key_s = key[order]
        col_s = col[order]
        size_s = sz[order]
        base_s = aid[order]
        atom_rank = torch.cumsum(size_s, 0) - size_s          # exclusive
        total = atom_rank[-1:] + size_s[-1:]
        col_first = torch.searchsorted(col_s.contiguous(),
                                       _arange(n_cols + 1, device))
        atoms_before = torch.cat([atom_rank, total])[col_first]
        pcnt = _round_up_icl(atoms_before[1:] - atoms_before[:-1])
        col_start = torch.cat([torch.zeros_like(pcnt[:1]),
                               torch.cumsum(pcnt, 0)])
        overflow = torch.clamp_min(col_start[-1] - S, 0)
        c_of = torch.clamp(col_s, 0, n_cols - 1)
        slot_a = col_start[c_of] + (atom_rank - atoms_before[c_of])
        valid = col_s < n_cols
        slot_col = torch.searchsorted(col_start[1:].contiguous(),
                                      _arange(S, device), right=True)
        pad_key = (torch.clamp_max(slot_col, n_cols - 1) << ZBITS) | zmax
        # slot S is a sink for invalid rows; it is cut off below and never
        # read
        perm = torch.full((S + 1,), n_base, dtype=torch.int64, device=device)
        key_sorted = torch.cat([pad_key, torch.zeros_like(pad_key[:1])])
        for k in range(max_sz):
            m = valid & (k < size_s)
            sl = torch.where(m, torch.clamp(slot_a + k, 0, S - 1),
                             torch.full_like(slot_a, S))
            perm[sl] = torch.where(m, base_s + k,
                                   torch.full_like(base_s, n_base))
            key_sorted[sl] = key_s
        return perm[:S], key_sorted[:S], col_start, overflow

    return sort


def make_window_fn(plan: ColPlan, per_slice_k: int = PER_SLICE_K,
                   triangular: bool = True, cross_j_size: int = None):
    """Window tables.

    windows(xs, keys, box, mask_s) -> (wl [NC, 3K] int32,
    nw [NC] int32, overflow): every (column offset, z-range) entry becomes
    its [lo, hi) slot range. Triangular tables clamp lo to the cluster
    start, so each unordered pair lies in exactly one tile; symmetric
    tables (`triangular=False`) keep the whole range, and every ordered
    pair lies in its i-cluster's tile. Wrap ranges read the opposite end
    of the column with the z image baked into the code; overlapping ranges
    carry different images and at most one image of a pair is inside the
    cutoff.

    cross_j_size=S_j: the cross tables. Cluster bounding boxes come from
    this plan's (subset) array, the slot ranges from a separate master j
    array of S_j slots sorted on the same column grid, whose keys and mask
    arrive as two more arguments: windows(xs, keys, box, mask_s, keys_j,
    mask_j). Never clamped (the cross kernel's group-id order keeps each
    pair once).

    per_slice_k > 0: every range is cut into 128-slot slice entries, K =
    per_slice_k, and the overflow is the excess slice count. per_slice_k
    = 0: the range table, K = plan.w_max whole ranges compacted to the
    front; the overflow is max(nw) - w_max.
    """
    nx, ny = plan.nx, plan.ny
    n_cols = nx * ny
    NC = plan.n_clusters
    K = per_slice_k
    rcw = plan.rc_wb
    zmax = (1 << ZBITS) - 1
    HB = 8                      # window-range z quantization (256 bins)
    SH = ZBITS - HB
    NB = 1 << HB
    clamp = triangular and cross_j_size is None

    def windows(xs, keys, box, mask_s, keys_j=None, mask_j=None):
        dev = xs.device
        lz = box[2]
        wx = box[0] / nx
        wy = box[1] / ny
        xc = xs.reshape(NC, ICL, 3)
        mc = mask_s.reshape(NC, ICL) > 0
        any_valid = mc.any(dim=1)
        if cross_j_size is None:
            keys_j, mask_j = keys, mask_s
        elif keys_j is None or keys_j.shape != (cross_j_size,):
            raise ValueError(f"cross windows need the master keys and mask "
                             f"of {cross_j_size} slots")
        # per-(column, z-bin) cumulative slot table of the j array; pads
        # sit in the per-column sentinel bin NB
        colk = torch.clamp(keys_j >> ZBITS, 0, n_cols - 1)
        bin8 = (keys_j & zmax) >> SH
        bucket = colk * (NB + 1) + torch.where(
            mask_j > 0, bin8, torch.full_like(bin8, NB))
        cum_flat = torch.searchsorted(
            bucket.contiguous(), _arange(n_cols * (NB + 1) + 1, dev))
        big = torch.tensor(1e30, dtype=xs.dtype, device=dev)

        def bb(axis, lo):
            v = xc[:, :, axis]
            if lo:
                return torch.amin(torch.where(mc, v, big), dim=1)
            return torch.amax(torch.where(mc, v, -big), dim=1)

        xlo_c, xhi_c = bb(0, True), bb(0, False)
        ylo_c, yhi_c = bb(1, True), bb(1, False)
        zmin_c, zmax_c = bb(2, True), bb(2, False)
        col_c = torch.clamp(keys.reshape(NC, ICL)[:, 0] >> ZBITS,
                            0, n_cols - 1)
        cx = col_c // ny
        cy = col_c - cx * ny
        cl_start = _arange(NC, dev) * ICL

        def zq(z):
            return torch.clamp((z / lz * NB).long(), 0, NB - 1)

        def side(j, n):
            return torch.where(j < 0, -1, torch.where(j >= n, 1, 0))

        blo_l, bhi_l, sc_l, jcol_l, ok_l = [], [], [], [], []
        for dx, dy in plan.offsets:
            jx = cx + dx
            jy = cy + dy
            sx = side(jx, nx)
            sy = side(jy, ny)
            jcol = (jx - sx * nx) * ny + (jy - sy * ny)
            # xy distance from the cluster bbox to the (unwrapped) column
            # rectangle tightens the z reach: zr = sqrt(rcw^2 - d_xy^2)
            jxlo = jx.to(xs.dtype) * wx
            jylo = jy.to(xs.dtype) * wy
            dxm = torch.clamp_min(torch.maximum(jxlo - xhi_c,
                                                xlo_c - (jxlo + wx)), 0.0)
            dym = torch.clamp_min(torch.maximum(jylo - yhi_c,
                                                ylo_c - (jylo + wy)), 0.0)
            zr2 = rcw * rcw - (dxm * dxm + dym * dym)
            in_reach = zr2 > 0.0
            zr = torch.sqrt(torch.clamp_min(zr2, 0.0))
            zlo_c = zmin_c - zr
            zhi_c = zmax_c + zr
            for wrap in (0, 1, 2):   # main, low wrap, high wrap
                if wrap == 0:
                    blo = zq(torch.clamp_min(zlo_c, 0.0))
                    bhi = zq(torch.minimum(zhi_c, lz))
                    ok = zhi_c > torch.clamp_min(zlo_c, 0.0)
                elif wrap == 1:      # zlo < 0: neighbours at the column top
                    blo = zq(zlo_c + lz)
                    bhi = torch.full_like(blo, NB - 1)
                    ok = zlo_c < 0.0
                else:                # zhi > Lz: neighbours at the bottom
                    bhi = zq(zhi_c - lz)
                    blo = torch.zeros_like(bhi)
                    ok = zhi_c > lz
                ok = ok & any_valid & in_reach & (bhi >= blo)
                szd = (1, 0, 2)[wrap]
                blo_l.append(blo)
                bhi_l.append(bhi)
                sc_l.append((sx + 1) | ((sy + 1) << 2) | (szd << 4))
                jcol_l.append(jcol)
                ok_l.append(ok)
        blo_all = torch.clamp(torch.stack(blo_l, 1), 0, NB - 1)  # [NC, E]
        bhi_all = torch.clamp(torch.stack(bhi_l, 1), 0, NB - 1)
        sc_all = torch.stack(sc_l, 1)
        base = torch.stack(jcol_l, 1) * (NB + 1)
        lo = cum_flat[base + blo_all]
        hi = cum_flat[base + bhi_all + 1]
        if clamp:
            lo = torch.maximum(lo, cl_start[:, None])
        good = torch.stack(ok_l, 1) & (hi > lo)
        zero = torch.zeros_like(lo)
        lo_all = torch.where(good, lo, zero)
        hi_all = torch.where(good, hi, zero)
        sc_all = torch.where(good, sc_all,
                             torch.full_like(sc_all, 1 | (1 << 2) | (1 << 4)))
        if not K:
            # range table: compact the good entries to the front by their
            # rank among the cluster's good entries
            W = plan.w_max
            nw = good.sum(1)
            pos = torch.cumsum(good.long(), 1) - 1              # [NC, E]
            sel = good[:, :, None] & (pos[:, :, None]
                                      == _arange(W, dev)[None, None, :])
            sel = sel.long()
            wl = torch.stack([(sel * a[:, :, None]).sum(1)
                              for a in (lo_all, hi_all, sc_all)], 2)
            overflow = torch.clamp_min(torch.max(nw) - W, 0)
            return (wl.reshape(NC, -1).to(torch.int32),
                    torch.clamp_max(nw, W).to(torch.int32), overflow)
        # cut every range into 128-slot slice entries
        s0 = lo_all >> 7
        nsl = torch.where(good, ((hi_all + 127) >> 7) - s0, zero)
        os_ = torch.cumsum(nsl, 1) - nsl                # exclusive [NC, E]
        ns = os_[:, -1] + nsl[:, -1]
        kk = _arange(K, dev)[None, None, :]
        sel = (kk >= os_[:, :, None]) & (kk < (os_ + nsl)[:, :, None])
        blk = s0[:, :, None] + (kk - os_[:, :, None])
        zk = torch.zeros_like(blk)
        lo_k = torch.sum(torch.where(
            sel, torch.maximum(lo_all[:, :, None], blk * 128), zk), 1)
        hi_k = torch.sum(torch.where(
            sel, torch.minimum(hi_all[:, :, None], (blk + 1) * 128), zk), 1)
        sc_k = torch.sum(sel.long() * sc_all[:, :, None], 1)
        overflow = torch.clamp_min(torch.max(ns) - K, 0)
        wl = torch.stack([lo_k, hi_k, sc_k], 2).reshape(NC, -1)
        return (wl.to(torch.int32), torch.clamp_max(ns, K).to(torch.int32),
                overflow)

    return windows


# ---------------------------------------------------------------------------
# Pair math
# ---------------------------------------------------------------------------

def _pair_tile(xi, yi, zi, qi, shi, sei, jx, jy, jz, jq, jsh, jse, valid,
               rc2, beta, coeffs, want_energy, mode, kpoly, mags=False,
               alch=None, self_guard=False):
    """Broadcast pair math of the kernel (same op order as csrc/colpair.cu).
    Returns (coeff = dV/dr2 masked, e_lj, e_c, dx, dy, dz, mag).
    `self_guard` drops pairs at r^2 <= 1e-9 (the symmetric table's guard
    against a clamped self pair; triangular and cross tables exclude the
    diagonal by their masks). With
    `mags`, mag = (|coeff| scale, |energy| scale): each the sum of the
    magnitudes of the terms that float32 roundoff acts on, the LJ force
    taken before the C1 blend factor gp (gp -> 0 at the clamp, so its
    absolute roundoff is relative to the unblended force) and the K-poly
    as its Horner on |c| and |t| (the monomial terms cancel); else None.

    `alch` is the per-pair coupling factor 1 - is_alch (1 - couple) of the
    has_alch kernels: Beutler softcore LJ and r^2-softcore Coulomb, with
    the erfcx force (the K-poly cannot carry the softcore 1/r_sc). For
    pairs with alch = 1 the softcore terms vanish (soft_c = 0, invd = 1)."""
    if alch is not None and kpoly is not None:
        raise ValueError("K-poly Coulomb cannot run with the alchemical "
                         "softcore: has_alch kernels take the erfcx force")
    dx = xi - jx
    dy = yi - jy
    dz = zi - jz
    r2 = dx * dx + dy * dy + dz * dz
    valid = valid & (r2 < rc2)
    if self_guard:
        valid = valid & (r2 > 1e-9)
    r2s = torch.clamp(r2, R2_MIN, rc2)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    if alch is not None:
        # sigma lanes are read in every mode, 'coul' too, as the reference
        # does; the SC_SIG2_MIN floor keeps them harmless there
        sigsc = shi + jsh
        a_lj = SC_ALPHA * (1.0 - alch)
        soft_c = torch.clamp_min(sigsc * sigsc, SC_SIG2_MIN) * a_lj
        inv_rc = torch.rsqrt(r2s + soft_c)
    else:
        inv_rc = inv_r
    dlj = zero
    dc = zero
    e_lj = e_c = None
    c_mag = e_mag = dc_mag = zero
    if mode != "coul":
        sig = shi + jsh                   # inputs are sigma/2
        eps4 = sei * jse                  # inputs are 2 sqrt(eps)
        if alch is not None:
            eps4 = eps4 * alch
        s2_raw = sig * sig * inv_r2
        s2, gp = _s2_clamped(s2_raw)
        s6 = s2 * s2 * s2
        if alch is not None:
            # Beutler: V = eps4 (inv^2 - inv), inv = s6 / (a s6 + 1)
            invd = 1.0 / (a_lj * s6 + 1.0)
            s6 = s6 * invd
            dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) \
                * (invd * invd) * (3.0 - 6.0 * s6)
        else:
            invd = None
            dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) * (3.0 - 6.0 * s6)
        if want_energy:
            e_lj = torch.where(valid, eps4 * (s6 * s6 - s6), zero)
        if mags:
            c_mag = eps4.abs() * inv_r2 * s2_raw * (s2 * s2)
            if invd is not None:
                c_mag = c_mag * (invd * invd)
            c_mag = c_mag * (3.0 + 6.0 * s6)
            e_mag = eps4.abs() * (s6 * s6 + s6)
    if mode != "lj":
        kqq = qi * jq                     # inputs are q sqrt(k_C)
        if alch is not None:
            kqq = kqq * alch
        if kpoly is not None and not want_energy:
            kc, kxmax = kpoly
            t = (r2s * inv_r) * (2.0 * beta / kxmax) - 1.0
            kk = kc[-1]
            for c in kc[-2::-1]:
                kk = kk * t + c
            dc = -kqq * (kk * (inv_r2 * inv_r))
            if mags:
                ta = t.abs()
                ka = abs(kc[-1])
                for c in kc[-2::-1]:
                    ka = ka * ta + abs(c)
                dc_mag = kqq.abs() * (ka * (inv_r2 * inv_r))
        else:
            x = beta * (r2s * inv_r)
            ex = torch.exp(-x * x)
            g = coeffs[-1]
            for c in coeffs[-2::-1]:
                g = g * x + c
            erfc_v = g * ex
            if alch is not None:
                # d/dr2 of erfc(beta r) / r_sc, r_sc^2 = r^2 + soft_c (erfc
                # keeps the real r)
                dc = -kqq * ((0.5 * _TWO_OVER_SQRT_PI * beta)
                             * ex * inv_r * inv_rc
                             + 0.5 * erfc_v * inv_rc * inv_rc * inv_rc)
            else:
                dc = -kqq * inv_r2 * (0.5 * erfc_v * inv_r
                                      + (0.5 * _TWO_OVER_SQRT_PI * beta) * ex)
            dc_mag = dc.abs()
            if want_energy:
                e_c = torch.where(valid, kqq * erfc_v * inv_rc, zero)
                e_mag = e_mag + e_c.abs()
    coeff = torch.where(valid, dlj + dc, zero)
    mag = None
    if mags:
        mag = (torch.where(valid, c_mag + dc_mag, zero),
               torch.where(valid, e_mag, zero) if want_energy else None)
    return coeff, e_lj, e_c, dx, dy, dz, mag


def colpair_plain(rows, pT, wl, nw, box, cfg, couple=None, stats=None,
                  i_base=None):
    """Plain torch version of the kernel: (f [S, 3], e_lj, e_c).

    `couple` (scalar, 1 = fully coupled) is read only by has_alch
    instances, which require it. Table entries may span several 128-slot
    slices (range tables); each is evaluated slice by slice.

    `i_base` selects the shard variant: the i rows are a [NCl*ICL, 8]
    block of clusters sitting at slot i_base of the j array pT [8, s_j],
    the tables are in j-array slots, and the result is (f_i [NCl*ICL, 3],
    f_j [s_j, 3], e_lj, e_c), the reduction left to the caller.

    `cfg.triangular` False selects the symmetric table: every ordered pair
    in its i-cluster's tile, the r^2 > 1e-9 self guard, no j reactions,
    and each cluster's energies halved. `cfg.cross` = (wlo, whi) selects
    the cross variant: the i rows are a separate subset array, pT the
    [8, s_j] master array, a j is kept when its group id lies in [wlo,
    whi) or exceeds the i's, and the result is (f_i, f_j [s_j, 3], e_lj,
    e_c) as for the shard.

    Vectorised over [clusters, slices, 64, 128], chunked over clusters so a
    chunk's tiles stay under CHUNK_ELEMS elements; reactions go back by
    index_add_. A `stats` dict, if given, receives the magnitudes that
    `colpair_parity` scales errors by: "pairs", the count of evaluated
    (in-cutoff, unmasked) pairs; "f_abs" [S] (shard and cross: [NCl*ICL +
    s_j], i rows then j slots), each site's sum over its pairs of the pair
    force's term magnitudes (`_pair_tile`'s mag); "e_cluster" [NC], each
    i-cluster's energy (LJ + Coulomb); "e_abs" [NC], its sum of pair
    energy term magnitudes; "pairs_near_rc", the count of unmasked pairs
    whose r^2 lies within NEAR_RC * rc^2 of rc^2, on either side; and, if
    the dict holds the key "keys" when it is passed, "keys": the sorted
    int64 keys of the evaluated pairs, (i row * s_j + j slot) * 64 + code.
    """
    NC = rows.shape[0] // ICL
    dev = rows.device
    K = wl.shape[1] // 3
    wl3 = wl.reshape(NC, K, 3).long()
    nw = nw.long()
    cross = cfg.cross is not None
    sym = not cfg.triangular and not cross
    two_out = i_base is not None or cross
    if cfg.has_alch:
        if couple is None:
            raise ValueError("has_alch colpair needs the couple value")
        omc = 1.0 - torch.as_tensor(couple, dtype=rows.dtype, device=dev)
    zeros3 = lambda n: torch.zeros((n, 3), dtype=rows.dtype, device=dev)
    if two_out:
        f_i, f_j = zeros3(rows.shape[0]), zeros3(pT.shape[1])
    else:
        f_i = f_j = zeros3(rows.shape[0])
    base = 0 if i_base is None else int(i_base)
    # each pair of the symmetric table is visited from both of its sites
    ehalf = 0.5 if sym else 1.0
    e_lj = torch.zeros((), dtype=rows.dtype, device=dev)
    e_c = torch.zeros((), dtype=rows.dtype, device=dev)
    want_keys = stats is not None and "keys" in stats
    key_parts = []
    if stats is not None:
        fa_i = fa_j = torch.zeros_like(f_j[:, 0])
        if two_out:
            fa_i = torch.zeros_like(f_i[:, 0])
        stats.update(pairs=0, pairs_near_rc=0,
                     e_cluster=torch.zeros_like(f_i[:NC, 0]),
                     e_abs=torch.zeros_like(f_i[:NC, 0]))
    lx, ly, lz = box[0], box[1], box[2]
    lanes = _arange(LANES, dev)
    lo_a, hi_a, code_a = wl3[..., 0], wl3[..., 1], wl3[..., 2]
    start_a = (lo_a >> 7) << 7
    # slices per active entry: 1 throughout a per-slice table
    nsl = torch.where(_arange(K, dev)[None, :] < nw[:, None],
                      ((hi_a + LANES - 1) >> 7) - (lo_a >> 7),
                      torch.zeros_like(lo_a))
    if NC and int(nsl.max()) > 1:
        # range entries: one row per (entry, slice), compacted per cluster;
        # each row keeps its entry's lo, hi and code
        first = torch.cumsum(nsl, 1) - nsl                        # [NC, K]
        nw = (first + nsl)[:, -1]
        kk = _arange(int(nw.max()), dev)[None, :]                 # [1, K2]
        e_of = ((kk[:, None, :] >= (first + nsl)[..., None]).sum(1)
                .clamp_max(K - 1))                                # [NC, K2]
        lo_a, hi_a, code_a = (torch.gather(a, 1, e_of)
                              for a in (lo_a, hi_a, code_a))
        start_a = torch.where(
            kk < nw[:, None],
            ((lo_a >> 7) + kk - torch.gather(first, 1, e_of)) << 7,
            torch.zeros_like(lo_a))
    kmax_all = int(nw.max()) if NC else 0
    cb = max(1, CHUNK_ELEMS // (max(kmax_all, 1) * ICL * LANES))
    for c0 in range(0, NC, cb):
        c1 = min(NC, c0 + cb)
        nwc = nw[c0:c1]
        kmax = int(nwc.max())
        if kmax == 0:
            continue
        lo, hi, code = (a[c0:c1, :kmax] for a in (lo_a, hi_a, code_a))
        start = start_a[c0:c1, :kmax]
        active = _arange(kmax, dev)[None, :] < nwc[:, None]       # [c, k]
        gid = start[..., None] + lanes                            # [c,k,L]
        pj = pT[:, gid]                                           # [8,c,k,L]
        shx = (((code & 3) - 1).to(rows.dtype) * lx)[..., None]
        shy = ((((code >> 2) & 3) - 1).to(rows.dtype) * ly)[..., None]
        shz = ((((code >> 4) & 3) - 1).to(rows.dtype) * lz)[..., None]
        irow = rows[c0 * ICL:c1 * ICL].reshape(c1 - c0, 1, ICL, 8)
        ii = lambda k: irow[..., k:k + 1]                         # [c,1,I,1]
        jj = lambda v: v[:, :, None, :]                           # [c,k,1,L]
        g = gid[:, :, None, :]
        if cfg.triangular and not cross:
            # triangle bound only on the range overlapping the own slots
            cl_base = base + (_arange(c1 - c0, dev) + c0)[:, None] * ICL
            islot = cl_base[:, :, None] + _arange(ICL, dev)       # [c,1,I]
            own = (lo < cl_base + ICL) & (hi > cl_base)           # [c, k]
            lo_eff = torch.where(own[..., None],
                                 torch.maximum(islot + 1, lo[..., None]),
                                 lo[..., None])[..., None]        # [c,k,I,1]
        else:
            lo_eff = lo[..., None, None]
        gi = ii(7)
        gj = jj(pj[7])
        jok = ((g >= lo_eff) & (g < hi[..., None, None])
               & active[..., None, None])
        if cross:
            wlo, whi = cfg.cross
            jok = jok & (((gj >= wlo) & (gj < whi)) | (gj > gi))
        else:
            jok = jok & (gj != gi)
        if cfg.water_filter is not None:
            wlo, whi = cfg.water_filter
            jok = jok & (((gi >= wlo) & (gi < whi))
                         | ((gj >= wlo) & (gj < whi)))
        alch = None
        if cfg.has_alch:
            cmi, cmj = ii(6), jj(pj[6])
            is_alch = cmi + cmj - 2.0 * cmi * cmj
            alch = 1.0 - is_alch * omc
        coeff, elj, ec, dx, dy, dz, mag = _pair_tile(
            ii(0), ii(1), ii(2), ii(3), ii(4), ii(5),
            jj(pj[0] + shx), jj(pj[1] + shy), jj(pj[2] + shz),
            jj(pj[3]), jj(pj[4]), jj(pj[5]), jok,
            cfg.rc2, cfg.beta, cfg.coeffs, cfg.want_energy, cfg.mode,
            cfg.kpoly, mags=stats is not None, alch=alch, self_guard=sym)
        c2 = 2.0 * coeff
        d = torch.stack([c2 * dx, c2 * dy, c2 * dz], -1)          # [c,k,I,L,3]
        f_i[c0 * ICL:c1 * ICL] -= d.sum(dim=(1, 3)).reshape(-1, 3)
        if not sym:
            f_j.index_add_(0, gid.reshape(-1), d.sum(dim=2).reshape(-1, 3))
        if cfg.want_energy:
            if elj is not None:
                e_lj = e_lj + ehalf * elj.sum()
            if ec is not None:
                e_c = e_c + ehalf * ec.sum()
        if stats is not None:
            r2 = dx * dx + dy * dy + dz * dz
            tested = jok & (r2 > 1e-9) if sym else jok
            ok = tested & (r2 < cfg.rc2)
            stats["pairs"] += int(torch.count_nonzero(ok))
            stats["pairs_near_rc"] += int(torch.count_nonzero(
                tested & ((r2 - cfg.rc2).abs() <= NEAR_RC * cfg.rc2)))
            if want_keys:
                cc, ck, ci, cl = torch.nonzero(ok, as_tuple=True)
                i_row = (cc + c0) * ICL + ci
                key_parts.append((i_row * pT.shape[1] + gid[cc, ck, cl])
                                 * 64 + code[cc, ck])
            dn = 2.0 * mag[0] * torch.sqrt(r2)                   # [c,k,I,L]
            fa_i[c0 * ICL:c1 * ICL] += dn.sum(dim=(1, 3)).reshape(-1)
            if not sym:
                fa_j.index_add_(0, gid.reshape(-1),
                                dn.sum(dim=2).reshape(-1))
            if cfg.want_energy:
                stats["e_cluster"][c0:c1] += ehalf * sum(
                    e.sum(dim=(1, 2, 3)) for e in (elj, ec) if e is not None)
                stats["e_abs"][c0:c1] += ehalf * mag[1].sum(dim=(1, 2, 3))
    if stats is not None:
        stats["f_abs"] = torch.cat([fa_i, fa_j]) if two_out else fa_j
    if want_keys:
        stats["keys"] = _sorted_keys(key_parts, dev)
    if two_out:
        return f_i, f_j, e_lj, e_c
    return f_i, e_lj, e_c


def _sorted_keys(parts, device):
    return torch.sort(torch.cat(
        parts + [torch.zeros(0, dtype=torch.int64, device=device)]))[0]


def colpair_parts(nc: int) -> int:
    """Blocks per i-cluster in csrc/colpair.cu's grid: at least 8, enough
    for the grid to reach GRID_BLOCKS, at most 64. From static shapes
    only, so a launch needs no host sync."""
    return int(min(64, max(8, -(-GRID_BLOCKS // max(int(nc), 1)))))


def colpair_work(rows, pT, wl, nw, box, cfg, i_base=None, keys=False):
    """Plain model of csrc/colpair.cu's schedule on the kernel's inputs
    (those of `colpair_plain`). The grid is NC x colpair_parts(NC) blocks
    of WORK_WARPS warps; each cluster's active entries are cut into
    CHUNK-slot j chunks clipped to [lo, hi), numbered across the entries,
    and chunk k goes to warp k mod (parts * WORK_WARPS) of the cluster.
    Every chunk tests its slots against the cluster's 64 i rows with the
    kernel's masks and r^2 < rc^2 and compacts the pairs that pass into
    32-lane batches. Returns a dict of counts: parts, blocks, warps
    (launched), busy_warps (with a chunk), chunks, slots (in-run j slots
    visited), tested (slot pairs tested), pairs (compacted), batches,
    lane_use (pairs per batch lane), max_warp_chunks, max_cluster_chunks;
    "table", per chunk its cluster, warp, entry, [lo, hi) and pair count;
    with `keys`, "keys", the sorted pair keys as colpair_plain's stats
    give them."""
    NC = rows.shape[0] // ICL
    dev = rows.device
    s_j = pT.shape[1]
    K = wl.shape[1] // 3
    parts = colpair_parts(NC)
    G = parts * WORK_WARPS
    w3 = wl.reshape(NC, K, 3).long()
    lo, hi, code = (w3[..., a].reshape(-1) for a in range(3))
    act = (_arange(K, dev)[None, :] < nw.long()[:, None]).reshape(-1)
    nch = torch.where(act & (hi > lo), (hi - lo + CHUNK - 1) // CHUNK,
                      torch.zeros_like(lo))
    k0 = torch.cumsum(nch.reshape(NC, K), 1).reshape(-1) - nch
    n_chunks = int(nch.sum())
    ent = torch.repeat_interleave(_arange(NC * K, dev), nch)
    kk = _arange(n_chunks, dev) - (torch.cumsum(nch, 0) - nch)[ent]
    c_of = ent // K
    warp = (k0[ent] + kk) % G
    c_lo = lo[ent] + kk * CHUNK
    c_hi = torch.minimum(c_lo + CHUNK, hi[ent])
    warp_chunks = torch.zeros(NC * G, dtype=torch.int64, device=dev)
    warp_chunks.index_add_(0, c_of * G + warp, torch.ones_like(warp))
    base = 0 if i_base is None else int(i_base)
    cross = cfg.cross is not None
    sym = not cfg.triangular and not cross
    irows = rows.reshape(NC, ICL, 8)
    lanes = _arange(CHUNK, dev)
    counts = torch.zeros(n_chunks, dtype=torch.int64, device=dev)
    slots, key_parts = 0, []
    step = max(1, CHUNK_ELEMS // (ICL * CHUNK))
    for t0 in range(0, n_chunks, step):
        sl = slice(t0, min(n_chunks, t0 + step))
        cc, e = c_of[sl], ent[sl]
        gid = c_lo[sl, None] + lanes                              # [t, L]
        in_run = (gid < c_hi[sl, None]) & (gid < s_j)
        pj = pT[:, torch.clamp(gid, 0, s_j - 1)]                  # [8,t,L]
        sh = [((((code[e] >> (2 * a)) & 3) - 1).to(rows.dtype)
               * box[a])[:, None] for a in range(3)]
        ir = irows[cc]                                            # [t,I,8]
        ii = lambda k: ir[:, :, k:k + 1]                          # [t,I,1]
        jj = lambda v: v[:, None, :]                              # [t,1,L]
        gi, gj = ii(7), jj(pj[7])
        ok = jj(in_run)
        if cross:
            wlo, whi = cfg.cross
            ok = ok & (((gj >= wlo) & (gj < whi)) | (gj > gi))
        else:
            if cfg.triangular:
                # the triangle bound on the entries over the own slots
                cl_base = base + cc * ICL
                own = (lo[e] < cl_base + ICL) & (hi[e] > cl_base)
                islot = cl_base[:, None] + _arange(ICL, dev)      # [t, I]
                ok = ok & (~own[:, None, None]
                           | (jj(gid) > islot[:, :, None]))
            ok = ok & (gj != gi)
            if cfg.water_filter is not None:
                wlo, whi = cfg.water_filter
                ok = ok & (((gi >= wlo) & (gi < whi))
                           | ((gj >= wlo) & (gj < whi)))
        dx = ii(0) - jj(pj[0] + sh[0])
        dy = ii(1) - jj(pj[1] + sh[1])
        dz = ii(2) - jj(pj[2] + sh[2])
        r2 = dx * dx + dy * dy + dz * dz
        ok = ok & (r2 < cfg.rc2)
        if sym:
            ok = ok & (r2 > 1e-9)
        counts[sl] = ok.sum(dim=(1, 2))
        slots += int(in_run.sum())
        if keys:
            ct, ci, cl = torch.nonzero(ok, as_tuple=True)
            key_parts.append(((cc[ct] * ICL + ci) * s_j + gid[ct, cl]) * 64
                             + code[e][ct])
    pairs = int(counts.sum())
    batches = int(((counts + 31) // 32).sum())
    out = dict(parts=parts, blocks=NC * parts, warps=NC * G,
               busy_warps=int((warp_chunks > 0).sum()), chunks=n_chunks,
               slots=slots, tested=ICL * slots, pairs=pairs,
               batches=batches,
               lane_use=pairs / (32 * batches) if batches else 0.0,
               max_warp_chunks=int(warp_chunks.max()) if NC else 0,
               max_cluster_chunks=(int(nch.reshape(NC, K).sum(1).max())
                                   if NC else 0),
               table=dict(cluster=c_of, warp=warp, entry=ent % K, lo=c_lo,
                          hi=c_hi, pairs=counts))
    if keys:
        out["keys"] = _sorted_keys(key_parts, dev)
    return out


def colpair_parity(f, e_cluster, f_ref, stats):
    """(force ratio, energy ratio) of a kernel's output against the plain
    version's, each error over the float32 scale that roundoff acts on:
    max over sites of max_axis|dF| / f_abs, and max over i-clusters of
    |dE| / e_abs (`stats` from colpair_plain on the same inputs; e_cluster
    [NC] the kernel's per-cluster energies). Excluded solute pairs carry
    ~1e5 kcal/mol/A at the C1 clamp, so a ratio to max|F| would let an
    error of a whole site force through at every other site."""
    err = (f - f_ref).abs().amax(dim=1)
    tiny = torch.finfo(f.dtype).tiny
    rel_f = float((err / torch.clamp_min(stats["f_abs"], tiny)).max())
    de = (e_cluster - stats["e_cluster"]).abs()
    rel_e = float((de / torch.clamp_min(stats["e_abs"], tiny)).max())
    return rel_f, rel_e


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

_MODES = {"lj": 0, "full": 1, "coul": 2}
# table kinds of csrc/colpair.cu
_TABLE_TRI, _TABLE_SYM, _TABLE_CROSS = 0, 1, 2


@dataclass(frozen=True)
class KernelCfg:
    """Constants of one kernel instance, as the plain version uses them."""
    mode: str
    want_energy: bool
    water_filter: Tuple[float, float] = None
    rc2: float = 0.0
    beta: float = 0.0
    coeffs: Tuple[float, ...] = ()
    kpoly: Tuple[Tuple[float, ...], float] = None
    has_alch: bool = False
    triangular: bool = True
    cross: Tuple[float, float] = None


class ColpairDirect:
    """direct(rows, pT, wl, nw, box, couple) -> (F [S, 3], e_lj, e_c).

    rows: [S, 8] f32 sorted rows (x, y, z, q sqrt(kC), sigma/2, 2 sqrt(eps),
          couple_mask, exclusion group id + 1; 0 marks a padded slot)
    pT:   [8, S] f32, the same transposed (the j side)
    wl:   [NC, 3K] int32 window entries (lo, hi, code): per-slice, or with
          `range_tables` the [NC, 3 w_max] range table; triangular, or
          with `triangular=False` symmetric (make_window_fn's flag)
    nw:   [NC] int32 entries per cluster

    triangular=False: the symmetric instance (every ordered pair from its
    i side, no reactions, energies halved). Only mode 'full' without the
    water filter or the shard is built, as FastSim runs it.

    local_shape=(nc_local, s_local, i_base): the shard variant. rows is
    the [nc_local*ICL, 8] block of this shard's clusters, sitting at slot
    i_base of the local j array pT [8, s_local] (own block and halo
    blocks); the table is in local slots. Returns (f_i [nc_local*ICL, 3],
    f_j [s_local, 3], e_lj, e_c): the caller reduces the halo reactions.

    cross=(wlo, whi, s_j): the cross variant. rows is a [NC*ICL, 8] subset
    array (the solute, sorted on the master's column grid), pT the [8, s_j]
    master array, the table make_window_fn(cross_j_size=s_j)'s. A j whose
    group id lies in [wlo, whi) (water) is always kept, any other only when
    its group id exceeds the i's, so each pair with a subset site counts
    once. Returns (f_i [NC*ICL, 3], f_j [s_j, 3], e_lj, e_c). Mode 'full'
    only, without has_alch.

    CUDA tensors launch the hand-written kernel (csrc/colpair.cu); CPU
    tensors take `colpair_plain`. The tracing counter named after the
    instance counts the kernel's launches (e.g. "colpair_coul_wf_force",
    "colpair_full_alch_force", "colpair_coul_wf_range_force",
    "colpair_full_range_shard_energy", "colpair_full_sym_force",
    "colpair_full_cross_energy"), across all instances. K-poly Coulomb is
    on iff force-only and mode != 'lj' and not has_alch. has_alch
    instances (softcore pairs of the coupled molecule, rows col 6 = couple
    mask) read `couple` as a 0-d tensor on the rows' device and take mode
    'full' or 'coul' (an alchemical solute sits in the L subset, which is
    then 'full').
    """

    def __init__(self, plan: ColPlan, want_energy: bool, mode: str = "full",
                 water_filter=None, has_alch: bool = False,
                 range_tables: bool = False, local_shape=None,
                 triangular: bool = True, cross=None):
        if mode not in _MODES:
            raise ValueError(f"unknown colpair mode {mode!r}")
        if has_alch and mode == "lj":
            raise ValueError("has_alch colpair takes mode 'full' or 'coul'")
        if (not triangular or cross is not None) and (
                mode != "full" or water_filter is not None
                or local_shape is not None):
            raise ValueError(
                "symmetric and cross colpair are built in mode 'full' only, "
                "without the water filter or the shard: other instances are "
                "not ported (ROADMAP.md Queue 2)")
        if cross is not None and has_alch:
            raise ValueError("cross colpair has no has_alch instance "
                             "(ROADMAP.md Queue 2)")
        self.w_ent = plan.w_max if range_tables else None
        self.local_shape = (None if local_shape is None
                            else tuple(int(v) for v in local_shape))
        self.cross_j = None if cross is None else int(cross[2])
        kpoly = None
        if not want_energy and mode != "lj" and not has_alch:
            kpoly = (tuple(float(v) for v in plan.kpoly_coeffs),
                     float(plan.kpoly_xmax))
        self.cfg = KernelCfg(
            mode=mode, want_energy=bool(want_energy),
            water_filter=(None if water_filter is None else
                          tuple(float(v) for v in water_filter)),
            rc2=float(plan.cutoff) ** 2, beta=float(plan.beta),
            coeffs=tuple(float(v) for v in plan.erfcx_coeffs), kpoly=kpoly,
            has_alch=bool(has_alch),
            triangular=bool(triangular) and cross is None,
            cross=(None if cross is None else
                   (float(cross[0]), float(cross[1]))))
        self.name = "_".join(
            ["colpair", mode] + (["wf"] if water_filter is not None else [])
            + (["alch"] if has_alch else [])
            + (["cross"] if cross is not None else
               [] if triangular else ["sym"])
            + (["range"] if range_tables else [])
            + (["shard"] if local_shape is not None else [])
            + ["energy" if want_energy else "force"])
        self._params = {}

    def params(self, device):
        """float32 [64] constants of this instance for the CUDA kernel
        (layout in csrc/colpair.cu), one copy per device."""
        if device not in self._params:
            c = self.cfg
            kp = () if c.kpoly is None else c.kpoly[0]
            if len(c.coeffs) > 24 or len(kp) > 24:
                raise ValueError("colpair kernel takes at most 24 "
                                 "polynomial coefficients")
            p = np.zeros(64, np.float32)
            p[0] = c.rc2
            p[1] = c.beta
            p[2] = 0.5 * _TWO_OVER_SQRT_PI * c.beta
            if c.kpoly is not None:
                p[3] = 2.0 * c.beta / c.kpoly[1]
            if c.water_filter is not None:
                p[4], p[5] = c.water_filter
            if c.cross is not None:
                p[4], p[5] = c.cross
            p[6] = len(c.coeffs)
            p[7] = len(kp)
            p[8:16] = (_S2_LO, _S2_HI, _S2_W, 0.5 / _S2_W, 1.0 / _S2_W,
                       R2_MIN, SC_ALPHA, SC_SIG2_MIN)
            p[16:16 + len(c.coeffs)] = c.coeffs
            p[40:40 + len(kp)] = kp
            self._params[device] = torch.as_tensor(p, device=device)
        return self._params[device]

    def __call__(self, rows, pT, wl, nw, box, couple):
        ls = self.local_shape
        n_i = rows.shape[0] if ls is None else ls[0] * ICL
        s_j = n_i if ls is None else ls[1]
        if self.cross_j is not None:
            s_j = self.cross_j
        if rows.shape != (n_i, 8) or pT.shape != (8, s_j) or s_j % LANES \
                or n_i % ICL:
            raise ValueError(f"colpair rows {tuple(rows.shape)} / pT "
                             f"{tuple(pT.shape)}: want [{n_i}, 8] / "
                             f"[8, {s_j}], a multiple of 128 j slots")
        if wl.shape[0] != n_i // ICL or wl.shape[1] % 3 or \
                nw.shape != (n_i // ICL,) or (
                    self.w_ent is not None and wl.shape[1] != 3 * self.w_ent):
            raise ValueError("colpair window table does not match rows")
        i_base = None if ls is None else ls[2]
        if rows.device.type == "cpu":
            return colpair_plain(rows, pT, wl, nw, box, self.cfg, couple,
                                 i_base=i_base)
        out = colpair_cuda(self.cfg, rows, pT, wl, nw, box,
                           self.params(rows.device), couple, i_base=i_base)
        tracing.count(self.name)
        e = out[-1]
        return (*out[:-1], e[:, 0].sum(), e[:, 1].sum())


def colpair_cuda(cfg: KernelCfg, rows, pT, wl, nw, box, params,
                 couple=None, i_base=None, counts=None):
    """Launch csrc/colpair.cu on the current stream: (f [S, 3], per-cluster
    energies [NC, 2] = (e_lj, e_c)); with `i_base` the shard variant,
    (f_i [NC*ICL, 3], f_j [s_j, 3], e [NC, 2]) for i rows sitting at slot
    i_base of the j array pT [8, s_j]; with `cfg.cross` the same triple
    for a subset i array against the master pT. The outputs and the
    kernel's scratch (per-(part, cluster) partial i-forces and energies,
    colpair_parts(NC) parts) are made here: the j reactions (and the
    i-forces where they share its buffer) zeroed, for the kernel adds
    them with atomics; a separate i-force buffer and the energies, which
    the kernel's part sum stores, left unset. has_alch instances read
    `couple` through its device pointer (a 0-d float32 tensor, changed per
    window and shifted inside dhdl without a host sync). `counts`, a
    one-element int64 tensor on the device, receives the number of pairs
    that passed the cutoff and mask test, added to what it holds. Counts
    no launch; `ColpairDirect` does."""
    import ctypes

    from ..cuda_build import load_library

    dev = rows.device
    NC = rows.shape[0] // ICL
    s_j = pT.shape[1]
    for name, t, dt in (("rows", rows, torch.float32),
                        ("pT", pT, torch.float32),
                        ("wl", wl, torch.int32), ("nw", nw, torch.int32),
                        ("box", box, torch.float32),
                        ("params", params, torch.float32)) + (
            (("counts", counts, torch.int64),) if counts is not None
            else ()):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"colpair: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
    if box.numel() != 3:
        raise ValueError("colpair: box must hold 3 extents")
    if counts is not None and counts.numel() != 1:
        raise ValueError("colpair: counts must hold one int64")
    cross = cfg.cross is not None
    if cross and i_base is not None:
        raise ValueError("colpair: cross has no shard variant")
    if not cross and ((0 if i_base is None else i_base) + NC * ICL > s_j or (
            i_base is None and s_j != rows.shape[0])):
        raise ValueError("colpair: the i rows do not sit in the j array")
    c_ptr = ctypes.c_void_p(None)
    if cfg.has_alch:
        if couple is None:
            raise ValueError("has_alch colpair needs the couple value")
        couple = torch.as_tensor(couple, dtype=torch.float32, device=dev)
        if couple.numel() != 1:
            raise ValueError("colpair: couple must be a scalar")
        couple = couple.contiguous()
        c_ptr = ctypes.c_void_p(couple.data_ptr())
    lib = load_library()
    f32 = dict(dtype=torch.float32, device=dev)
    two_out = i_base is not None or cross
    if two_out:
        f_i = torch.empty((NC * ICL, 3), **f32)
        f_j = torch.zeros((s_j, 3), **f32)
    elif cfg.triangular:
        f_i = f_j = torch.zeros((NC * ICL, 3), **f32)
    else:                       # symmetric: no reactions, rows stored
        f_i = f_j = torch.empty((NC * ICL, 3), **f32)
    e = torch.empty((NC, 2), **f32)
    parts = colpair_parts(NC)
    scratch = torch.empty(parts * NC * (3 * ICL + 2), **f32)
    table = _TABLE_CROSS if cross else (
        _TABLE_TRI if cfg.triangular else _TABLE_SYM)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.colpair_launch(
        table, _MODES[cfg.mode], int(cfg.want_energy),
        int(cfg.water_filter is not None), int(cfg.has_alch), NC, parts,
        wl.shape[1], s_j, 0 if i_base is None else int(i_base), ptr(wl),
        ptr(nw), ptr(rows), ptr(pT), ptr(box), ptr(params), c_ptr, ptr(f_i),
        ptr(f_j), ptr(e), ptr(scratch),
        ctypes.c_void_p(None) if counts is None else ptr(counts),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"colpair kernel launch failed: CUDA error {err}")
    if two_out:
        return f_i, f_j, e
    return f_i, e


# ---------------------------------------------------------------------------
# Matching pair-list formula (exclusion / 1-4 subtraction)
# ---------------------------------------------------------------------------

def pairlist_colpair_energy(x, box, idx, mask, q_kc, sig_half, eps_2sqrt,
                            couple_mask, couple, plan: ColPlan):
    """(e_lj, e_c) over an explicit pair list with the kernel's arithmetic
    (rsqrt, erfcx polynomial, r^2 and C1 sigma clamps), so subtracting it
    from the window sums cancels excluded pairs to float32 roundoff.
    Differentiable. Index rows must be legal slots."""
    from .pbc import minimum_image

    beta = plan.beta
    coeffs = plan.erfcx_coeffs
    rc2 = plan.cutoff ** 2
    i, j = idx[:, 0], idx[:, 1]
    d = minimum_image(x[i] - x[j], box)
    r2 = torch.sum(d * d, dim=-1)
    valid = (r2 < rc2) & (r2 > 1e-9) & (mask > 0)
    r2s = torch.clamp(r2, R2_MIN, rc2)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    sig = sig_half[i] + sig_half[j]
    cm_i, cm_j = couple_mask[i], couple_mask[j]
    cpl = 1.0 - (cm_i + cm_j - 2.0 * cm_i * cm_j) * (1.0 - couple)
    eps4 = eps_2sqrt[i] * eps_2sqrt[j] * cpl
    sig2 = sig * sig
    # alchemical softcore (a_lj and soft_c are exactly 0 for plain pairs,
    # so the plain values are reproduced)
    a_lj = SC_ALPHA * (1.0 - cpl)
    soft_c = torch.clamp_min(sig2, SC_SIG2_MIN) * a_lj
    inv_rc = torch.rsqrt(r2s + soft_c)
    s2, _ = _s2_clamped(sig2 * inv_r2)
    s6 = s2 * s2 * s2
    s6 = s6 * (1.0 / (a_lj * s6 + 1.0))        # Beutler 1/(a s6 + 1)
    e_lj = eps4 * (s6 * s6 - s6)
    kqq = q_kc[i] * q_kc[j] * cpl
    xx = beta * (r2s * inv_r)
    ex = torch.exp(-xx * xx)
    g = coeffs[-1]
    for c in coeffs[-2::-1]:
        g = g * xx + c
    e_c = kqq * (g * ex) * inv_rc
    zero = torch.zeros_like(e_lj)
    return (torch.sum(torch.where(valid, e_lj, zero)),
            torch.sum(torch.where(valid, e_c, zero)))
