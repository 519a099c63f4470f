"""Column-pair direct-space LJ + Ewald Coulomb: the plan, the rebuild
tables, the pair-list twin used for exclusion subtraction, and the
direct-space kernel (port of molchanica_tpu.ops.pallas.colpair).

The state lives sorted by (xy column, z). Atoms are binned into xy columns
at least rc + skin wide and z-ordered within each column; every column run
is padded to a multiple of ICL = 64 slots, so each 64-slot i-cluster is
column-pure and its j-neighbourhood is a set of slot ranges in the 3x3
column window. The window table lists, per cluster, up to `per_slice_k`
entries (lo, hi, code): a [lo, hi) slot range inside one 128-slot slice
plus the periodic x/y/z shift baked into `code` (2 bits per axis, value
s + 1 for s in {-1, 0, 1} box lengths), so the kernel needs no per-pair
minimum image. Tables are triangular: every unordered pair is evaluated
once, the reaction force goes to j (Newton's third law).

`ColpairDirect` is the kernel: the hand-written CUDA kernel in
csrc/colpair.cu for CUDA tensors, and `colpair_plain` (the same function
in plain torch) for CPU tensors. `pairlist_colpair_energy` evaluates the
same pair math over an explicit pair list, so excluded pairs that the
kernel adds are subtracted to float32 roundoff.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

# Atoms per i-cluster.
ICL = 64
ZBITS = 14        # z quantization bits in the sort key
LANES = 128       # j slots per slice
PER_SLICE_K = 64  # window entries per cluster (doubled on overflow)
CHUNK_ELEMS = 1 << 25  # pair-tile elements per chunk of colpair_plain
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

# r^2 floor (A^2): closer pairs (mid-clash, or excluded intramolecular
# pairs) are evaluated at the clamped distance, in the kernel and in the
# subtraction path alike.
R2_MIN = 0.25
# Alchemical softcore constants (pair-list path only in this port).
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


def make_anchor_sort_fn(plan: ColPlan, anchor_ids, sizes, atom_mask_base,
                        device="cpu"):
    """Molecule-anchor column sort: argsort over anchors (one key per water
    block or free atom), then expand each anchor to `size` consecutive
    slots. Returns sort(x_base, box) -> (perm [S] base ids (n_base =
    dummy), key_sorted [S], col_start [n_cols+1], overflow)."""
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


def make_window_fn(plan: ColPlan, per_slice_k: int = PER_SLICE_K):
    """Triangular per-slice window tables.

    windows(xs, keys, box, mask_s) -> (wl [NC, 3K] int32,
    nw [NC] int32, overflow): every (column offset, z-range) entry becomes
    its [lo, hi) slot range (lo clamped to the cluster start, so each
    unordered pair lies in exactly one tile), cut into 128-slot slices.
    Wrap ranges read the opposite end of the column with the z image baked
    into the code; overlapping ranges carry different images and at most
    one image of a pair is inside the cutoff.
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

    def windows(xs, keys, box, mask_s):
        dev = xs.device
        lz = box[2]
        wx = box[0] / nx
        wy = box[1] / ny
        xc = xs.reshape(NC, ICL, 3)
        mc = mask_s.reshape(NC, ICL) > 0
        any_valid = mc.any(dim=1)
        # per-(column, z-bin) cumulative slot table; pads sit in the
        # per-column sentinel bin NB
        colk = torch.clamp(keys >> ZBITS, 0, n_cols - 1)
        bin8 = (keys & zmax) >> SH
        bucket = colk * (NB + 1) + torch.where(
            mask_s > 0, bin8, torch.full_like(bin8, NB))
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
        lo = torch.maximum(lo, cl_start[:, None])      # triangular
        good = torch.stack(ok_l, 1) & (hi > lo)
        zero = torch.zeros_like(lo)
        lo_all = torch.where(good, lo, zero)
        hi_all = torch.where(good, hi, zero)
        sc_all = torch.where(good, sc_all,
                             torch.full_like(sc_all, 1 | (1 << 2) | (1 << 4)))
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
               rc2, beta, coeffs, want_energy, mode, kpoly, mags=False):
    """Broadcast pair math of the kernel (same op order as csrc/colpair.cu).
    Returns (coeff = dV/dr2 masked, e_lj, e_c, dx, dy, dz, mag). With
    `mags`, mag = (|coeff| scale, |energy| scale): each the sum of the
    magnitudes of the terms that float32 roundoff acts on, the LJ force
    taken before the C1 blend factor gp (gp -> 0 at the clamp, so its
    absolute roundoff is relative to the unblended force) and the K-poly
    as its Horner on |c| and |t| (the monomial terms cancel); else None."""
    dx = xi - jx
    dy = yi - jy
    dz = zi - jz
    r2 = dx * dx + dy * dy + dz * dz
    valid = valid & (r2 < rc2)
    r2s = torch.clamp(r2, R2_MIN, rc2)
    inv_r = torch.rsqrt(r2s)
    inv_r2 = inv_r * inv_r
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    dlj = zero
    dc = zero
    e_lj = e_c = None
    c_mag = e_mag = dc_mag = zero
    if mode != "coul":
        sig = shi + jsh                   # inputs are sigma/2
        eps4 = sei * jse                  # inputs are 2 sqrt(eps)
        s2_raw = sig * sig * inv_r2
        s2, gp = _s2_clamped(s2_raw)
        s6 = s2 * s2 * s2
        dlj = eps4 * inv_r2 * (gp * s2_raw) * (s2 * s2) * (3.0 - 6.0 * s6)
        if want_energy:
            e_lj = torch.where(valid, eps4 * (s6 * s6 - s6), zero)
        if mags:
            c_mag = (eps4.abs() * inv_r2 * s2_raw * (s2 * s2)
                     * (3.0 + 6.0 * s6))
            e_mag = eps4.abs() * (s6 * s6 + s6)
    if mode != "lj":
        kqq = qi * jq                     # inputs are q sqrt(k_C)
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
            dc = -kqq * inv_r2 * (0.5 * erfc_v * inv_r
                                  + (0.5 * _TWO_OVER_SQRT_PI * beta) * ex)
            dc_mag = dc.abs()
            if want_energy:
                e_c = torch.where(valid, kqq * erfc_v * inv_r, zero)
                e_mag = e_mag + e_c.abs()
    coeff = torch.where(valid, dlj + dc, zero)
    mag = None
    if mags:
        mag = (torch.where(valid, c_mag + dc_mag, zero),
               torch.where(valid, e_mag, zero) if want_energy else None)
    return coeff, e_lj, e_c, dx, dy, dz, mag


def colpair_plain(rows, pT, wl, nw, box, cfg, stats=None):
    """Plain torch version of the kernel: (f [S, 3], e_lj, e_c).

    Vectorised over [clusters, slices, 64, 128], chunked over clusters so a
    chunk's tiles stay under CHUNK_ELEMS elements; reactions go back by
    index_add_. A `stats` dict, if given, receives the magnitudes that
    `colpair_parity` scales errors by: "pairs", the count of evaluated
    (in-cutoff, unmasked) pairs; "f_abs" [S], each site's sum over its
    pairs of the pair force's term magnitudes (`_pair_tile`'s mag);
    "e_cluster" [NC], each i-cluster's energy (LJ + Coulomb); "e_abs"
    [NC], its sum of pair energy term magnitudes.
    """
    S = rows.shape[0]
    NC = S // ICL
    dev = rows.device
    K = wl.shape[1] // 3
    wl3 = wl.reshape(NC, K, 3).long()
    nw = nw.long()
    f = torch.zeros((S, 3), dtype=rows.dtype, device=dev)
    e_lj = torch.zeros((), dtype=rows.dtype, device=dev)
    e_c = torch.zeros((), dtype=rows.dtype, device=dev)
    if stats is not None:
        stats.update(pairs=0, f_abs=torch.zeros_like(f[:, 0]),
                     e_cluster=torch.zeros_like(f[:NC, 0]),
                     e_abs=torch.zeros_like(f[:NC, 0]))
    lx, ly, lz = box[0], box[1], box[2]
    lanes = _arange(LANES, dev)
    kmax_all = int(nw.max()) if NC else 0
    cb = max(1, CHUNK_ELEMS // (max(kmax_all, 1) * ICL * LANES))
    for c0 in range(0, NC, cb):
        c1 = min(NC, c0 + cb)
        nwc = nw[c0:c1]
        kmax = int(nwc.max())
        if kmax == 0:
            continue
        ent = wl3[c0:c1, :kmax]
        lo, hi, code = ent[..., 0], ent[..., 1], ent[..., 2]
        active = _arange(kmax, dev)[None, :] < nwc[:, None]       # [c, k]
        gid = ((lo >> 7) << 7)[..., None] + lanes                 # [c,k,L]
        pj = pT[:, gid]                                           # [8,c,k,L]
        shx = (((code & 3) - 1).to(rows.dtype) * lx)[..., None]
        shy = ((((code >> 2) & 3) - 1).to(rows.dtype) * ly)[..., None]
        shz = ((((code >> 4) & 3) - 1).to(rows.dtype) * lz)[..., None]
        irow = rows[c0 * ICL:c1 * ICL].reshape(c1 - c0, 1, ICL, 8)
        ii = lambda k: irow[..., k:k + 1]                         # [c,1,I,1]
        jj = lambda v: v[:, :, None, :]                           # [c,k,1,L]
        # triangle bound only on the range overlapping the own slots
        cl_base = (_arange(c1 - c0, dev) + c0)[:, None] * ICL     # [c, 1]
        islot = cl_base[:, :, None] + _arange(ICL, dev)           # [c,1,I]
        own = (lo < cl_base + ICL) & (hi > cl_base)               # [c, k]
        lo_eff = torch.where(own[..., None],
                             torch.maximum(islot + 1, lo[..., None]),
                             lo[..., None])                       # [c,k,I]
        g = gid[:, :, None, :]
        gi = ii(7)
        gj = jj(pj[7])
        jok = ((g >= lo_eff[..., None]) & (g < hi[..., None, None])
               & (gj != gi) & active[..., None, None])
        if cfg.water_filter is not None:
            wlo, whi = cfg.water_filter
            jok = jok & (((gi >= wlo) & (gi < whi))
                         | ((gj >= wlo) & (gj < whi)))
        coeff, elj, ec, dx, dy, dz, mag = _pair_tile(
            ii(0), ii(1), ii(2), ii(3), ii(4), ii(5),
            jj(pj[0] + shx), jj(pj[1] + shy), jj(pj[2] + shz),
            jj(pj[3]), jj(pj[4]), jj(pj[5]), jok,
            cfg.rc2, cfg.beta, cfg.coeffs, cfg.want_energy, cfg.mode,
            cfg.kpoly, mags=stats is not None)
        c2 = 2.0 * coeff
        d = torch.stack([c2 * dx, c2 * dy, c2 * dz], -1)          # [c,k,I,L,3]
        f[c0 * ICL:c1 * ICL] -= d.sum(dim=(1, 3)).reshape(-1, 3)
        f.index_add_(0, gid.reshape(-1), d.sum(dim=2).reshape(-1, 3))
        if cfg.want_energy:
            if elj is not None:
                e_lj = e_lj + elj.sum()
            if ec is not None:
                e_c = e_c + ec.sum()
        if stats is not None:
            r2 = dx * dx + dy * dy + dz * dz
            stats["pairs"] += int(torch.count_nonzero(jok & (r2 < cfg.rc2)))
            dn = 2.0 * mag[0] * torch.sqrt(r2)                   # [c,k,I,L]
            stats["f_abs"][c0 * ICL:c1 * ICL] += dn.sum(dim=(1, 3)).reshape(-1)
            stats["f_abs"].index_add_(0, gid.reshape(-1),
                                      dn.sum(dim=2).reshape(-1))
            if cfg.want_energy:
                stats["e_cluster"][c0:c1] += sum(
                    e.sum(dim=(1, 2, 3)) for e in (elj, ec) if e is not None)
                stats["e_abs"][c0:c1] += mag[1].sum(dim=(1, 2, 3))
    return f, e_lj, e_c


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


class ColpairDirect:
    """direct(rows, pT, wl, nw, box, couple) -> (F [S, 3], e_lj, e_c).

    rows: [S, 8] f32 sorted rows (x, y, z, q sqrt(kC), sigma/2, 2 sqrt(eps),
          couple_mask, exclusion group id + 1; 0 marks a padded slot)
    pT:   [8, S] f32, the same transposed (the j side)
    wl:   [NC, 3K] int32 triangular per-slice window entries (lo, hi, code)
    nw:   [NC] int32 entries per cluster

    CUDA tensors launch the hand-written kernel (csrc/colpair.cu); CPU
    tensors take `colpair_plain`. `launches[name]` counts the kernel's
    launches per variant name (e.g. "colpair_coul_wf_force"), across all
    instances. K-poly Coulomb is on iff force-only and mode != 'lj'.
    """
    launches: dict = {}

    def __init__(self, plan: ColPlan, want_energy: bool, mode: str = "full",
                 water_filter=None, has_alch: bool = False):
        if has_alch:
            raise NotImplementedError(
                "alchemical colpair kernels are not ported yet")
        if mode not in _MODES:
            raise ValueError(f"unknown colpair mode {mode!r}")
        kpoly = None
        if not want_energy and mode != "lj":
            kpoly = (tuple(float(v) for v in plan.kpoly_coeffs),
                     float(plan.kpoly_xmax))
        self.cfg = KernelCfg(
            mode=mode, want_energy=bool(want_energy),
            water_filter=(None if water_filter is None else
                          tuple(float(v) for v in water_filter)),
            rc2=float(plan.cutoff) ** 2, beta=float(plan.beta),
            coeffs=tuple(float(v) for v in plan.erfcx_coeffs), kpoly=kpoly)
        self.name = "_".join(
            ["colpair", mode] + (["wf"] if water_filter is not None else [])
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
            p[6] = len(c.coeffs)
            p[7] = len(kp)
            p[8:14] = (_S2_LO, _S2_HI, _S2_W, 0.5 / _S2_W, 1.0 / _S2_W,
                       R2_MIN)
            p[16:16 + len(c.coeffs)] = c.coeffs
            p[40:40 + len(kp)] = kp
            self._params[device] = torch.as_tensor(p, device=device)
        return self._params[device]

    def __call__(self, rows, pT, wl, nw, box, couple):
        S = rows.shape[0]
        if rows.shape != (S, 8) or pT.shape != (8, S) or S % LANES:
            raise ValueError(f"colpair rows {tuple(rows.shape)} / pT "
                             f"{tuple(pT.shape)}: want [S, 8] / [8, S], "
                             "S a multiple of 128")
        if wl.shape[0] != S // ICL or wl.shape[1] % 3 or \
                nw.shape != (S // ICL,):
            raise ValueError("colpair window table does not match rows")
        if rows.device.type == "cpu":
            return colpair_plain(rows, pT, wl, nw, box, self.cfg)
        f, e = colpair_cuda(self.cfg, rows, pT, wl, nw, box,
                            self.params(rows.device))
        ColpairDirect.launches[self.name] = \
            ColpairDirect.launches.get(self.name, 0) + 1
        return f, e[:, 0].sum(), e[:, 1].sum()


def colpair_cuda(cfg: KernelCfg, rows, pT, wl, nw, box, params):
    """Launch csrc/colpair.cu on the current stream: (f [S, 3], per-cluster
    energies [NC, 2] = (e_lj, e_c)). The outputs are made here: f zeroed
    (the kernel adds i-forces and j reactions with atomics). Counts no
    launch; `ColpairDirect` does."""
    import ctypes

    from ..cuda_build import load_library

    dev = rows.device
    S = rows.shape[0]
    NC = S // ICL
    for name, t, dt in (("rows", rows, torch.float32),
                        ("pT", pT, torch.float32),
                        ("wl", wl, torch.int32), ("nw", nw, torch.int32),
                        ("box", box, torch.float32),
                        ("params", params, torch.float32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"colpair: {name} must be a contiguous {dt} "
                             f"tensor on {dev}")
    if box.numel() != 3:
        raise ValueError("colpair: box must hold 3 extents")
    lib = load_library()
    f = torch.zeros((S, 3), dtype=torch.float32, device=dev)
    e = torch.zeros((NC, 2), dtype=torch.float32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.colpair_launch(
        _MODES[cfg.mode], int(cfg.want_energy),
        int(cfg.water_filter is not None), NC, wl.shape[1], S,
        ptr(wl), ptr(nw), ptr(rows), ptr(pT), ptr(box), ptr(params),
        ptr(f), ptr(e),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"colpair kernel launch failed: CUDA error {err}")
    return f, e


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
