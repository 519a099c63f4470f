"""Cell-grid direct-space LJ + Ewald Coulomb for MdSim: the plan, the
rebuild and the kernel (port of molchanica_tpu.ops.pallas.direct_force).

Atoms are binned into a dense grid of nc cells per axis (side >= cutoff,
capacity C slots per cell). A ghost halo one cell wide replicates the
wrapped-around cells with their positions shifted by -box / +box, so the
kernel needs no minimum image, and the 3x3x3 neighbourhood of an interior
cell (i, j, k) is 9 runs ("slabs") of 3 consecutive ghost z-cells, i.e.
3 C contiguous slots each. Slab (dx, dy) starts at
base_g + ((dx gy + dy) gz) C with base_g = (((i+h) gy + (j+h)) gz + k) C;
note k, not k + h: ghost z-cells k..k+2 are interior k-1..k+1.

`DirectForce` is the kernel behind MdSim's `direct(x, box, couple, beta,
slot_atom, inv_slot) -> (F, e_lj, e_c, overflow)`: the hand-written CUDA
kernel in csrc/direct_force.cu for CUDA tensors, `direct_force_plain`
(the same function in plain torch) for CPU tensors;
`direct_force_work` is the plain model of that kernel's schedule. Each
pair is evaluated from both of its cells; forces are center-side only and
the energies half-summed per cell. Excluded and 1-4 pairs are left out
inside the pair loop: each row carries its site's index, which the
topology's exclusion table (ops/exclusions.py) is looked up with. The
reference adds those pairs and subtracts them again in its rest energy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import tracing
from ..constants import COULOMB_CONST
from .colpair import _sorted_keys
from .exclusions import Exclusions

SOFTCORE_ALPHA = 0.5

# Per-pair LJ energy clip (kcal/mol), applied identically in the kernels
# and their plain versions, for overlaps of pairs that are not excluded;
# the LJ force is zero where the raw energy reaches it.
LJ_CLIP = 1.0e7

# Abramowitz-Stegun 7.1.26 erfc coefficients
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)

# pair-tile elements per chunk of direct_force_plain
CHUNK_ELEMS = 1 << 22

# the schedule of csrc/direct_force.cu (direct_force_work models it)
PART_I = 32           # at most this many center sites per block
WORK_WARPS = 8        # warps per block
QCAP = 512            # a warp's queue of (i, j) pairs
BOX_MARGIN = 1.0001   # relative margin on rc^2 of the staging prefilter


def erfc_approx(x):
    """erfc(x) for x >= 0, |abs err| < 1.5e-7. Returns (erfc, exp(-x^2))."""
    t = 1.0 / (1.0 + _AS_P * x)
    poly = t * (_AS_A[0] + t * (_AS_A[1] + t * (
        _AS_A[2] + t * (_AS_A[3] + t * _AS_A[4]))))
    ex = torch.exp(-x * x)
    return poly * ex, ex


@dataclass(frozen=True)
class WindowPlan:
    nc: Tuple[int, int, int]     # interior cells per axis
    capacity: int                # slots per cell
    halo: int                    # ghost width in cells
    cell_side: Tuple[float, float, float]
    cutoff: float
    n_atoms: int                 # padded atom count (topology size)

    @property
    def n_cells(self) -> int:
        return self.nc[0] * self.nc[1] * self.nc[2]

    @property
    def ghost_dims(self) -> Tuple[int, int, int]:
        h = self.halo
        return (self.nc[0] + 2 * h, self.nc[1] + 2 * h, self.nc[2] + 2 * h)


def plan_window(box_extent, cutoff: float, n_atoms_real: int,
                n_atoms_pad: int, x0=None) -> WindowPlan:
    """Cell geometry: the largest cell side >= cutoff (halo 1, 9 slabs of 3
    cells), capacity 128, or 256 where the densest cell needs headroom.
    Asserts a box of at least 3 cells per axis and occupancy headroom."""
    box = np.asarray(box_extent, np.float64)
    nc = np.maximum((box / cutoff).astype(int), 1)
    side = box / nc
    h = 1
    assert (nc >= 3).all(), \
        f"box {box} too small for the cell-grid window at cutoff {cutoff}"
    n_cells = int(np.prod(nc))
    if x0 is not None:
        xr = np.asarray(x0)[:n_atoms_real]
        u = xr / box - np.floor(xr / box)
        ci = np.minimum((u * nc).astype(int), nc - 1)
        flat = ci[:, 0] * (nc[1] * nc[2]) + ci[:, 1] * nc[2] + ci[:, 2]
        occ = int(np.bincount(flat, minlength=n_cells).max())
    else:
        occ = int(math.ceil(n_atoms_real / n_cells))
    cap = 128 if occ * 1.4 <= 128 else 256
    assert occ * 1.15 <= cap, \
        f"max cell occupancy {occ} exceeds the window capacity {cap}"
    return WindowPlan(
        nc=tuple(int(v) for v in nc), capacity=cap, halo=h,
        cell_side=tuple(float(v) for v in side), cutoff=cutoff,
        n_atoms=n_atoms_pad)


def make_rebuild_fn(plan: WindowPlan, atom_mask):
    """rebuild(x, box) -> (slot_atom [n_cells C] int64 (-1 empty),
    inv_slot [N] int64, overflow int64). A stable sort by cell; atoms past
    a cell's capacity go to the sink slot n_cells C, which is cut off, and
    count as overflow (their inv_slot is 0). Each call runs inside the
    tracing span "k2.rebuild" and counts once in the counter "k2_rebuild"
    (under torch.func.vmap, once for all replicas)."""
    ncx, ncy, ncz = plan.nc
    cap = plan.capacity
    n_cells = plan.n_cells
    n = plan.n_atoms

    def rebuild(x, box):
        tracing.count("k2_rebuild")
        with tracing.span("k2.rebuild"):
            return _rebuild(x, box)

    def _rebuild(x, box):
        dev = x.device
        u = x / box
        u = u - torch.floor(u)
        ci = torch.clamp_max((u[:, 0] * ncx).to(torch.int64), ncx - 1)
        cj = torch.clamp_max((u[:, 1] * ncy).to(torch.int64), ncy - 1)
        ck = torch.clamp_max((u[:, 2] * ncz).to(torch.int64), ncz - 1)
        cell = ci * (ncy * ncz) + cj * ncz + ck
        cell = torch.where(atom_mask > 0, cell, torch.full_like(cell,
                                                                n_cells))
        order = torch.argsort(cell, stable=True)
        cell_sorted = cell[order].contiguous()
        seg_start = torch.searchsorted(cell_sorted, cell_sorted, right=False)
        rank = torch.arange(n, device=dev) - seg_start
        real = cell_sorted < n_cells
        overflow = torch.sum((rank >= cap) & real)
        ok = (rank < cap) & real
        slot_of_sorted = torch.where(ok, cell_sorted * cap + rank,
                                     torch.full_like(rank, n_cells * cap))
        # scatters out of place, so that torch.func.vmap can batch the
        # rebuild over replicas (parallel/replicas.py)
        slot_atom = torch.full((n_cells * cap + 1,), -1, dtype=torch.int64,
                               device=dev).index_put(
            (slot_of_sorted,), torch.where(ok, order,
                                           torch.full_like(order, -1)))
        inv_slot = torch.zeros((n,), dtype=torch.int64, device=dev).index_put(
            (order,), torch.where(ok, slot_of_sorted,
                                  torch.zeros_like(slot_of_sorted)))
        return slot_atom[:-1], inv_slot, overflow

    return rebuild


def ghost_tables(plan: WindowPlan):
    """(src [G] interior slot of each ghost slot, shift [G, 3] in box
    lengths: -1 below the interior, +1 above, 0 inside), from a
    ghost->interior cell map made in numpy: the wrap pad of the reference."""
    h = plan.halo
    cap = plan.capacity
    axes = []
    for ng, nc_ in zip(plan.ghost_dims, plan.nc):
        g = np.arange(ng)
        s = np.zeros(ng, np.float32)
        s[g < h] = -1.0
        s[g >= nc_ + h] = 1.0
        axes.append(((g - h) % nc_, s))
    (sx, shx), (sy, shy), (sz, shz) = axes
    ncy, ncz = plan.nc[1], plan.nc[2]
    src_cell = (sx[:, None, None] * (ncy * ncz) + sy[None, :, None] * ncz
                + sz[None, None, :]).reshape(-1)
    shift = np.stack(np.broadcast_arrays(
        shx[:, None, None], shy[None, :, None], shz[None, None, :]),
        -1).reshape(-1, 3)
    src = (src_cell[:, None] * cap + np.arange(cap)).reshape(-1)
    return src, np.repeat(shift, cap, axis=0)


def slab_starts(plan: WindowPlan, device):
    """[n_cells, 9] ghost slot where each cell's slabs start."""
    _, ncy, ncz = plan.nc
    _, gy, gz = plan.ghost_dims
    h, cap = plan.halo, plan.capacity
    p = np.arange(plan.n_cells)
    i = p // (ncy * ncz)
    j = (p - i * (ncy * ncz)) // ncz
    k = p - i * (ncy * ncz) - j * ncz
    base = (((i + h) * gy + (j + h)) * gz + k) * cap
    offs = np.array([((dx * gy + dy) * gz) * cap
                     for dx in range(-h, h + 1) for dy in range(-h, h + 1)])
    return torch.as_tensor(base[:, None] + offs[None, :], device=device)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _pair_terms(c, sl, couple, beta, mags):
    """Pair math of the kernel over in-cutoff pairs (same op order as
    csrc/direct_force.cu). c, sl: the 8 center and slab columns, [P] each.
    Returns (coeff = dV/dr2, e_lj, e_c, (dx, dy, dz), mag): mag, with
    `mags`, is |LJ term| + |Coulomb term| of dV/dr2, the LJ term taken
    as |eps4 cpl| (2 lj_inv + 1) inv_den^2 3 s6 / r2s so that
    the cancellation in 2 lj_inv - 1 near the LJ minimum does not hide its
    roundoff."""
    cx, cy, cz, cq, cs, ce, cc, _ = c
    sx, sy, sz, sq, ss, se, sc, _ = sl
    dx = cx - sx
    dy = cy - sy
    dz = cz - sz
    r2 = dx * dx + dy * dy + dz * dz
    r2s = torch.clamp_min(r2, 1e-4)
    inv_r2 = 1.0 / r2s
    sig = 0.5 * (cs + ss)
    eps4 = 4.0 * torch.sqrt(ce * se)
    is_alch = cc + sc - 2.0 * cc * sc
    cpl = 1.0 - is_alch * (1.0 - couple)
    a_sc = SOFTCORE_ALPHA * (1.0 - cpl)
    s2 = sig * sig * inv_r2
    s6 = s2 * s2 * s2
    inv_den = 1.0 / (a_sc * s6 + 1.0)
    lj_inv = s6 * inv_den
    lj_pre = eps4 * cpl
    e_lj_raw = lj_pre * (lj_inv * lj_inv - lj_inv)
    e_lj = torch.clamp(e_lj_raw, -LJ_CLIP, LJ_CLIP)
    unclipped = torch.abs(e_lj_raw) < LJ_CLIP
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    dlj = torch.where(unclipped, lj_pre * (2.0 * lj_inv - 1.0)
                      * (inv_den * inv_den) * (-3.0 * s6 * inv_r2), zero)
    r = torch.sqrt(r2s)
    inv_r = 1.0 / r
    erfc_v, expv = erfc_approx(beta * r)
    kqq = COULOMB_CONST * cq * sq * cpl
    e_c = kqq * erfc_v * inv_r
    dc = -0.5 * kqq * inv_r2 * (erfc_v * inv_r
                                + (_TWO_OVER_SQRT_PI * beta) * expv)
    mag = None
    if mags:
        lj_mag = torch.where(
            unclipped, torch.abs(lj_pre) * (2.0 * lj_inv + 1.0)
            * (inv_den * inv_den) * (3.0 * s6 * inv_r2), zero)
        mag = lj_mag + torch.abs(dc)
    return dlj + dc, e_lj, e_c, (dx, dy, dz), mag


def _site(col):
    """The site index a row's column 7 carries (its index + 1; 0 on an empty
    slot, which reads -1)."""
    return col.to(torch.int64) - 1


def direct_force_plain(center, ghost, starts, couple, beta, rc2,
                       stats=None, *, excl: Exclusions):
    """Plain torch version of the kernel: out [n_cells C, 4], forces in
    columns 0-2 and the cell's half-summed (e_lj, e_c) in column 3, rows 0
    and 1 of the cell. Slab by slab and chunked over cells, the distance
    test runs on dense [cells, C, 3 C] tiles and the pair math on the
    pairs that pass it and that `excl` (an ops/exclusions.py table,
    looked up with the sites that the rows' column 7 carries) does not
    exclude; sums go back by index_add_, the cell
    energies in float64 as the kernel sums them.

    A `stats` dict, if given, receives the scales `direct_force_parity`
    divides errors by: "pairs", the count of evaluated (valid) pairs;
    "f_abs" [n_cells C], each slot's sum over its pairs of 2 r (|LJ force
    term| + |Coulomb force term|) (see `_pair_terms`); "e_cell" [n_cells],
    each cell's half-summed LJ + Coulomb energy; "e_abs" [n_cells], its
    half sum of |e_lj| + |e_c|; "e_abs_lj" and "e_abs_c", the half sums of
    |e_lj| and of |e_c| over all pairs (the float32 scale of the two energy
    totals).
    With the key "keys" in `stats` it also receives "keys", the sorted
    int64 keys center slot * G + ghost slot of the evaluated pairs.

    With a leading replica axis (center [R, n_cells C, 8], ghost [R, 8,
    G], couple a scalar or [R]) it returns [R, n_cells C, 4], each replica
    its own single-replica result (no `stats`)."""
    if center.dim() == 3:
        if stats is not None:
            raise ValueError("direct_force_plain: stats take one replica")
        cpl = torch.as_tensor(couple).expand(center.shape[0])
        return torch.stack([
            direct_force_plain(c, g, starts, cp, beta, rc2, excl=excl)
            for c, g, cp in zip(center, ghost, cpl)])
    S = center.shape[0]
    n_cells, n_slab = starts.shape
    cap = S // n_cells
    L = 3 * cap
    dev = center.device
    out = torch.zeros((S, 4), dtype=center.dtype, device=dev)
    want_keys = stats is not None and "keys" in stats
    key_parts = []
    if stats is not None:
        stats.update(pairs=0, f_abs=torch.zeros_like(out[:, 0]),
                     e_cell=torch.zeros_like(out[:n_cells, 0]),
                     e_abs=torch.zeros_like(out[:n_cells, 0]),
                     e_abs_lj=0.0, e_abs_c=0.0)
    lane = torch.arange(L, device=dev)
    cb = max(1, CHUNK_ELEMS // (cap * L))
    for c0 in range(0, n_cells, cb):
        c1 = min(n_cells, c0 + cb)
        crow = center[c0 * cap:c1 * cap].reshape(c1 - c0, cap, 8)
        acc = torch.zeros(((c1 - c0) * cap, 3), dtype=center.dtype,
                          device=dev)
        e = torch.zeros((2, c1 - c0), dtype=torch.float64, device=dev)
        for s in range(n_slab):
            g = ghost[:, starts[c0:c1, s, None] + lane]           # [8, c, L]
            dx = crow[:, :, 0:1] - g[0][:, None, :]                # [c, C, L]
            dy = crow[:, :, 1:2] - g[1][:, None, :]
            dz = crow[:, :, 2:3] - g[2][:, None, :]
            r2 = dx * dx + dy * dy + dz * dz
            valid = ((r2 < rc2) & (r2 > 1e-9) & (crow[:, :, 7:8] > 0.5)
                     & (g[7][:, None, :] > 0.5))
            ci, ii, li = torch.nonzero(valid, as_tuple=True)
            keep = ~excl.excluded(_site(crow[ci, ii, 7]),
                                  _site(g[7, ci, li]))
            ci, ii, li = ci[keep], ii[keep], li[keep]
            cv = crow[ci, ii]                                      # [P, 8]
            sv = g[:, ci, li]                                      # [8, P]
            coeff, elj, ec, d, mag = _pair_terms(
                cv.unbind(1), sv.unbind(0), couple, beta, stats is not None)
            slot = ci * cap + ii
            if want_keys:
                key_parts.append((slot + c0 * cap) * ghost.shape[1]
                                 + starts[c0 + ci, s] + li)
            acc.index_add_(0, slot, torch.stack([coeff * dd for dd in d], 1))
            e[0].index_add_(0, ci, elj.double())
            e[1].index_add_(0, ci, ec.double())
            if stats is not None:
                r = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
                stats["pairs"] += int(slot.numel())
                stats["f_abs"].index_add_(0, slot + c0 * cap,
                                          2.0 * mag * r)
                e_abs = 0.5 * (torch.abs(elj) + torch.abs(ec))
                stats["e_abs"].index_add_(0, ci + c0, e_abs)
                stats["e_abs_lj"] += 0.5 * float(torch.abs(elj).sum())
                stats["e_abs_c"] += 0.5 * float(torch.abs(ec).sum())
        out[c0 * cap:c1 * cap, :3] = -2.0 * acc
        e_rows = out[c0 * cap:c1 * cap, 3].view(c1 - c0, cap)
        e_rows[:, 0] = 0.5 * e[0]
        e_rows[:, 1] = 0.5 * e[1]
        if stats is not None:
            stats["e_cell"][c0:c1] = 0.5 * (e[0] + e[1])
    if want_keys:
        stats["keys"] = _sorted_keys(key_parts, dev)
    return out


def direct_force_work(center, ghost, starts, rc2, n_sm=132, keys=False, *,
                      excl: Exclusions):
    """Plain model of csrc/direct_force.cu's schedule on the kernel's inputs
    (those of `direct_force_plain`). The grid is n_cells x C / PART_I
    blocks of WORK_WARPS warps. A cell's real sites, in slot order, are cut
    into ceil(n_c / PART_I) even ranges, one per active block; the others
    exit. An active block stages, in scan order (the 9 slabs of 3 C ghost
    slots), the real sites of the 27 neighbour cells whose squared distance
    to the bounding box of its own sites is below rc^2 BOX_MARGIN (float32,
    without FMA, as the kernel); cuts them into 32-site chunks, chunk k to
    warp k mod WORK_WARPS; and per chunk queues the pairs with r^2 < rc^2
    and r^2 > 1e-9 i by i, running the math on 32-lane batches whenever
    the queue could not take another i (more than QCAP - 32 pairs) and
    after the last i; a queued pair that `excl` excludes takes its lane of
    a batch and adds nothing. Blocks are dealt to `n_sm` SMs round-robin
    in launch order (blockIdx.x fastest) for the per-SM load.

    Returns a dict of counts: parts (per cell), blocks, active_blocks,
    warps_per_sm (active warps), sites (center sites over the parts),
    max_part_sites, min_part_sites, scanned (neighbourhood slots read), real
    (real sites among them), staged (kept by the prefilter), tested (i, j
    tests), chunks, queued, pairs (queued and not excluded), batches,
    lane_use (pairs per batch lane),
    max_warp_chunks, sm_batches_max and sm_batches_mean (math batches per
    SM); with `keys`, "keys", the sorted pair keys as
    direct_force_plain's stats give them."""
    S = center.shape[0]
    n_cells = starts.shape[0]
    cap = S // n_cells
    G = ghost.shape[1]
    dev = center.device
    parts = cap // PART_I
    rc2_box = (torch.tensor(rc2, dtype=torch.float32)
               * torch.tensor(BOX_MARGIN, dtype=torch.float32)).item()
    scan = (starts[:, :, None]
            + torch.arange(3 * cap, device=dev)).reshape(n_cells, -1)
    tot = dict(sites=0, scanned=0, real=0, staged=0, tested=0, chunks=0,
               queued=0, pairs=0, batches=0, max_warp_chunks=0,
               max_part_sites=0, min_part_sites=PART_I)
    block_batches, key_parts = [], []
    for p in range(n_cells):
        rows = center[p * cap:(p + 1) * cap]
        real = torch.nonzero(rows[:, 7] > 0.5).squeeze(1)
        n_c = real.numel()
        n_part = -(-n_c // PART_I)
        g_real = scan[p][ghost[7, scan[p]] > 0.5]
        nb = ghost[:, g_real]                                   # [8, n]
        for q in range(n_part):
            own = real[q * n_c // n_part:(q + 1) * n_c // n_part]
            ci = rows[own]                                      # [n_i, 8]
            lo, hi = ci[:, :3].amin(0)[:, None], ci[:, :3].amax(0)[:, None]
            d = torch.clamp_min(torch.maximum(lo - nb[:3], nb[:3] - hi), 0.0)
            keep = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2] < rc2_box
            gj, sj = g_real[keep], nb[:, keep]
            n_i, n_j = own.numel(), gj.numel()
            dx = ci[:, 0:1] - sj[0][None, :]                    # [n_i, n_j]
            dy = ci[:, 1:2] - sj[1][None, :]
            dz = ci[:, 2:3] - sj[2][None, :]
            r2 = dx * dx + dy * dy + dz * dz
            hit = (r2 < rc2) & (r2 > 1e-9)
            kept = hit & ~excl.excluded(_site(ci[:, 7])[:, None],
                                        _site(sj[7])[None, :])
            n_ch = -(-n_j // 32)
            per = torch.zeros((n_i, n_ch * 32), dtype=torch.int64,
                              device=dev)
            per[:, :n_j] = hit
            per = per.reshape(n_i, n_ch, 32).sum(2)             # [n_i, n_ch]
            cnt = torch.zeros(n_ch, dtype=torch.int64, device=dev)
            batches = 0
            for ii in range(n_i):
                cnt = cnt + per[ii]
                flush = (cnt > QCAP - 32) | (ii == n_i - 1)
                batches += int(torch.where(flush, (cnt + 31) // 32,
                                           torch.zeros_like(cnt)).sum())
                cnt = torch.where(flush, torch.zeros_like(cnt), cnt)
            tot["sites"] += n_i
            tot["max_part_sites"] = max(tot["max_part_sites"], n_i)
            tot["min_part_sites"] = min(tot["min_part_sites"], n_i)
            tot["scanned"] += scan.shape[1]
            tot["real"] += g_real.numel()
            tot["staged"] += n_j
            tot["tested"] += n_i * n_j
            tot["chunks"] += n_ch
            tot["queued"] += int(hit.sum())
            tot["pairs"] += int(kept.sum())
            tot["batches"] += batches
            tot["max_warp_chunks"] = max(tot["max_warp_chunks"],
                                         -(-n_ch // WORK_WARPS))
            block_batches.append((q * n_cells + p, batches))
            if keys:
                ii, jj = torch.nonzero(kept, as_tuple=True)
                key_parts.append((p * cap + own[ii]) * G + gj[jj])
    sm = torch.zeros(n_sm, dtype=torch.int64)
    for k, (_, b) in enumerate(sorted(block_batches)):
        sm[k % n_sm] += b
    active = len(block_batches)
    out = dict(parts=parts, blocks=n_cells * parts, active_blocks=active,
               warps_per_sm=active * WORK_WARPS / n_sm, **tot,
               lane_use=(tot["pairs"] / (32 * tot["batches"])
                         if tot["batches"] else 0.0),
               sm_batches_max=int(sm.max()),
               sm_batches_mean=float(sm.float().mean()))
    if keys:
        out["keys"] = _sorted_keys(key_parts, dev)
    return out


def direct_force_parity(f, e_cell, f_ref, stats):
    """(force ratio, energy ratio) of a kernel's output against the plain
    version's: max over slots of max_axis|dF| / f_abs, and max over cells
    of |dE| / e_abs (`stats` from direct_force_plain on the same inputs;
    f, f_ref [S, 3]; e_cell [n_cells] the kernel's cell energies). Site
    forces span orders of magnitude (a solute atom's, a water O's), so a
    ratio to max|F| alone would let through an error that is large for a
    site with a small force."""
    err = (f - f_ref).abs().amax(dim=1)
    tiny = torch.finfo(f.dtype).tiny
    rel_f = float((err / torch.clamp_min(stats["f_abs"], tiny)).max())
    de = (e_cell - stats["e_cell"]).abs()
    rel_e = float((de / torch.clamp_min(stats["e_abs"], tiny)).max())
    return rel_f, rel_e


def cell_energies(out, n_cells):
    """[n_cells, 2] (e_lj, e_c) half sums from a kernel output [S, 4] (with
    a leading replica axis, [R, n_cells, 2] from [R, S, 4])."""
    return out[..., 3].reshape(out.shape[:-2] + (n_cells, -1))[..., :2]


# ---------------------------------------------------------------------------
# The kernel wrapper
# ---------------------------------------------------------------------------

def image_shift(x, box):
    """box floor(x / box): the whole-box image that brings x into [0, box),
    fixed at a rebuild for the steps until the next one."""
    return box * torch.floor(x / box)


class DirectForce:
    """direct(x, box, couple, beta, slot_atom, inv_slot, shift=None) ->
    (F [N, 3], e_lj, e_c, overflow): the cell-grid kernel for one topology
    and plan (the reference's make_pallas_direct_fn).

    The wrapper moves the positions by `shift` [N, 3] (whole boxes), which
    the caller takes from `image_shift` at the rebuild that made slot_atom;
    None takes it at this call, i.e. wraps x into [0, box) as the
    reference does on every call. The two agree until an atom crosses the
    box face after a rebuild: the reference then wraps it to the far side
    while its slot stays in the near cell, so it loses every kernel pair.
    With the shift fixed at the rebuild it stays a little outside [0, box)
    in its cell until the next rebuild. The wrapper then builds the center
    rows [n_cells C, 8] (x, y, z, q, sigma, eps, couple_mask and, for
    valid, the site's index + 1; empty slots read a zero row) and the ghost
    array [8, G] (property-major, shifted by whole boxes), then runs the
    hand-written CUDA kernel (csrc/direct_force.cu) for CUDA tensors or
    `direct_force_plain` for CPU tensors, both leaving out the pairs of
    `excl` (the topology's ops/exclusions.py table). The tracing counter
    "direct_force" counts the kernel's launches across instances; the
    spans "k2.inputs" and "k2.kernel" mark the tables and the launch with
    its energy sum. Overflow is detected at rebuild; the returned one is
    0.

    Every argument but box and beta may carry a leading replica axis (x
    [R, N, 3], couple [R], slot_atom [R, n_cells C], inv_slot and shift
    likewise): then R independent grids of one plan run as one launch
    (the kernel's grid z axis), F is [R, N, 3] and the energies [R]. A
    launch counts once, whatever R.
    """

    def __init__(self, top, plan: WindowPlan, excl: Exclusions):
        self.plan = plan
        self.rc2 = float(plan.cutoff) ** 2
        dev = top.charges.device
        self.atom_mask = top.atom_mask
        self.excl = excl
        n = top.atom_mask.shape[0]
        if n >= 2 ** 24:
            raise ValueError(f"DirectForce: {n} sites; a float32 row holds "
                             f"site indices below 2^24")
        site = (torch.arange(n, device=dev) + 1).to(top.atom_mask.dtype)
        props = torch.stack([top.charges * top.atom_mask, top.lj_sigma,
                             top.lj_eps, top.couple_mask,
                             top.atom_mask * site],
                            dim=1).to(torch.float32)
        self.props = props                                   # [N, 5]
        src, shift = ghost_tables(plan)
        self.gsrc = torch.as_tensor(src, device=dev)
        self.gshift = torch.as_tensor(shift, device=dev)
        self.starts = slab_starts(plan, dev)

    def inputs(self, x, box, slot_atom, shift=None):
        """(center [n_cells C, 8], ghost [8, G]) for the kernel; with a
        leading replica axis, [R, n_cells C, 8] and [R, 8, G]."""
        n = self.plan.n_atoms
        x = x.to(torch.float32)
        x = x - (image_shift(x, box) if shift is None else shift)
        lead = x.shape[:-2]
        rows = torch.cat([
            torch.cat([x, self.props.expand(lead + self.props.shape)],
                      dim=-1),
            torch.zeros(lead + (1, 8), dtype=x.dtype, device=x.device)],
            dim=-2)
        idx = torch.where(slot_atom < 0, torch.full_like(slot_atom, n),
                          slot_atom)
        center = torch.gather(rows, -2, idx[..., None].expand(
            idx.shape + (8,)))
        ghost = center[..., self.gsrc, :]
        ghost = torch.cat([ghost[..., :3] + self.gshift * box,
                           ghost[..., 3:]], dim=-1)
        return center, ghost.transpose(-1, -2).contiguous()

    def kernel(self, center, ghost, couple, beta):
        """out [n_cells C, 4] (or [R, n_cells C, 4]) from the CUDA kernel
        (CUDA tensors, one launch counted) or the plain version (CPU
        tensors)."""
        if center.device.type == "cpu":
            return direct_force_plain(center, ghost, self.starts, couple,
                                      beta, self.rc2, excl=self.excl)
        out = direct_force_cuda(self.plan, center, ghost, couple, beta,
                                excl=self.excl)
        tracing.count("direct_force")
        return out

    def __call__(self, x, box, couple, beta, slot_atom, inv_slot,
                 shift=None):
        with tracing.span("k2.inputs"):
            center, ghost = self.inputs(x, box, slot_atom, shift)
        with tracing.span("k2.kernel"):
            out = self.kernel(center, ghost, couple, beta)
        f_atoms = torch.gather(out[..., :3], -2, inv_slot[..., None].expand(
            inv_slot.shape + (3,))) * self.atom_mask[:, None]
        e = cell_energies(out, self.plan.n_cells)
        zero = torch.zeros((), dtype=torch.int64, device=out.device)
        return f_atoms, e[..., 0].sum(-1), e[..., 1].sum(-1), zero


def direct_force_cuda(plan: WindowPlan, center, ghost, couple, beta,
                      counts=None, *, excl: Exclusions):
    """Launch csrc/direct_force.cu on the current stream: out [n_cells C,
    4], laid out as direct_force_plain's, without the pairs `excl` (an
    ops/exclusions.py table on the card) excludes. With a leading replica axis
    (center [R, n_cells C, 8], ghost [R, 8, G], couple and beta scalars or
    [R]) one launch runs the R grids and returns [R, n_cells C, 4].
    `counts`, an int64 tensor on the card with one element per replica,
    gets the kernel's count of the pairs that passed its cutoff and
    exclusion tests added.
    With couple and beta on the card the launch copies nothing from the
    host, so it can be captured in a CUDA graph; a Python float is copied
    at every call. Counts no launch; `DirectForce` does."""
    import ctypes

    from ..cuda_build import load_library

    dev = center.device
    cap = plan.capacity
    S = plan.n_cells * cap
    gx, gy, gz = plan.ghost_dims
    G = gx * gy * gz * cap
    lead = tuple(center.shape[:-2])
    R = center.shape[0] if lead else 1
    if len(lead) > 1 or center.shape != lead + (S, 8) \
            or ghost.shape != lead + (8, G):
        raise ValueError(f"direct_force: center {tuple(center.shape)} / "
                         f"ghost {tuple(ghost.shape)}: want [R,] [{S}, 8] "
                         f"/ [R,] [8, {G}]")
    if cap % PART_I or cap > 256 or plan.halo != 1 or G >= 2 ** 31 \
            or not 0 < R < 65536:
        raise ValueError(f"direct_force: capacity must be a multiple of "
                         f"{PART_I} up to 256, halo 1, fewer than 2^31 "
                         f"ghost slots, 1 to 65,535 replicas")
    params = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                          device=dev).expand(R)
                          for v in (couple, beta)], dim=1).contiguous()
    for name, t in (("center", center), ("ghost", ghost),
                    ("params", params)):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"direct_force: {name} must be a contiguous "
                             f"float32 tensor on {dev}")
    if counts is not None and (counts.device != dev or counts.numel() != R
                               or counts.dtype != torch.int64
                               or not counts.is_contiguous()):
        raise ValueError(f"direct_force: counts must be {R} int64 on {dev}")
    bits = excl.bits
    if bits.device != dev or bits.dtype != torch.int32 \
            or not bits.is_contiguous():
        raise ValueError(f"direct_force: the exclusion table must be a "
                         f"contiguous int32 tensor on {dev}")
    lib = load_library()
    out = torch.empty(lead + (S, 4), dtype=torch.float32, device=dev)
    scratch = torch.empty((R * plan.n_cells * (cap // PART_I) * 2,),
                          dtype=torch.float64, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = lib.direct_force_launch(
        R, plan.n_cells, cap, plan.nc[1], plan.nc[2], gy, gz, G,
        ctypes.c_float(float(plan.cutoff) ** 2), ptr(center), ptr(ghost),
        ptr(params), ptr(out), ptr(scratch),
        ctypes.c_void_p(None) if counts is None else ptr(counts),
        ptr(bits), int(bits.shape[1]),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"direct_force kernel launch failed: CUDA error "
                           f"{err}")
    return out
