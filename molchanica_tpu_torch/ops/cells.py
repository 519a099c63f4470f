"""Cell-binned direct space for periodic systems: the dense shift window
(port of molchanica_tpu.ops.cells).

Atoms are binned into a dense [ncx, ncy, ncz, C] grid (fixed capacity C,
cell side ~ cutoff / 2) and every pair block is cell against shifted cell
for a static stencil of lattice shifts covering the cutoff sphere; a shift
is a `torch.roll` over the cell axes. The loop over the stencil runs in
Python, one [cells, C, C] tile per shift: the whole stencil at once does
not fit.

Two functions are built on the grid:
  make_xla_direct_force_fn   MdSim's "window" backend: analytic forces
                             with the kernel's pair arithmetic (A&S erfc,
                             softcore, LJ clip);
  make_cell_direct_space_fn  the energy of method "cells_pme": exact erfc;
                             differentiable, one checkpointed tile per
                             shift under autograd.
Both leave out the excluded and 1-4 pairs, looked up by the two sites'
indices in the topology's exclusion table (ops/exclusions.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..constants import COULOMB_CONST
from .direct_force import LJ_CLIP, SOFTCORE_ALPHA, erfc_approx
from .exclusions import Exclusions
from .nonbonded import lorentz_berthelot, pair_lj_coulomb
from .pbc import minimum_image

_TWO_OVER_SQRT_PI = 2.0 / math.sqrt(math.pi)


def plan_cells(box_extent, cutoff: float, n_atoms_real: int,
               capacity_factor: float = 1.7, target_cell_side: float = None,
               x0=None):
    """Host-side geometry: (nc (3,), capacity, shifts [S, 3] int32). With
    positions `x0` the capacity is calibrated from the actual max cell
    occupancy (whole waters in one cell make the mean unsafe)."""
    box = np.asarray(box_extent, np.float64)
    s_t = target_cell_side or max(cutoff / 2.0, 3.0)
    nc = np.maximum((box / s_t).astype(int), 1)
    cell_side = box / nc
    assert (cutoff <= box / 2.0 + 1e-6).all(), \
        f"cutoff {cutoff} must be <= half the box {box}"
    r = np.ceil(cutoff / cell_side).astype(int)
    # per-axis shifts; a stencil wider than the axis wraps onto itself, so
    # it is deduplicated to visit every neighbour cell once
    ax_shifts = []
    for ax in range(3):
        if 2 * r[ax] + 1 <= nc[ax]:
            ax_shifts.append(list(range(-r[ax], r[ax] + 1)))
        else:
            lo = -(nc[ax] // 2)
            ax_shifts.append(list(range(lo, lo + nc[ax])))

    def min_ax_dist(s, ax):
        s_mod = min(abs(s) % nc[ax], nc[ax] - abs(s) % nc[ax])
        return max(s_mod - 1, 0) * cell_side[ax]

    shifts = []
    for dx in ax_shifts[0]:
        for dy in ax_shifts[1]:
            for dz in ax_shifts[2]:
                d = np.array([min_ax_dist(dx, 0), min_ax_dist(dy, 1),
                              min_ax_dist(dz, 2)])
                if np.linalg.norm(d) <= cutoff:
                    shifts.append((dx, dy, dz))
    n_cells = int(np.prod(nc))
    mean_occ = n_atoms_real / n_cells
    if x0 is not None:
        xr = np.asarray(x0)[:n_atoms_real]
        u = xr / box - np.floor(xr / box)
        ci = np.minimum((u * nc).astype(int), nc - 1)
        flat = ci[:, 0] * (nc[1] * nc[2]) + ci[:, 1] * nc[2] + ci[:, 2]
        max_occ = np.bincount(flat, minlength=n_cells).max()
        cap = int(math.ceil(max_occ * capacity_factor / 8.0)) * 8
    else:
        cap = int(math.ceil(mean_occ * capacity_factor / 8.0)) * 8
    cap = max(cap, 16)
    return tuple(int(v) for v in nc), cap, np.asarray(shifts, np.int32)


def bin_atoms(x, box, atom_mask, nc, capacity):
    """(grid [n_cells, C] int64 with -1 empty, overflow count). A stable
    sort by cell; padding atoms go to no cell."""
    n = x.shape[0]
    ncx, ncy, ncz = nc
    n_cells = ncx * ncy * ncz
    dev = x.device
    u = x / box
    u = u - torch.floor(u)
    ci = torch.clamp_max((u[:, 0] * ncx).to(torch.int64), ncx - 1)
    cj = torch.clamp_max((u[:, 1] * ncy).to(torch.int64), ncy - 1)
    ck = torch.clamp_max((u[:, 2] * ncz).to(torch.int64), ncz - 1)
    cell = ci * (ncy * ncz) + cj * ncz + ck
    cell = torch.where(atom_mask > 0, cell, torch.full_like(cell, n_cells))
    order = torch.argsort(cell, stable=True)
    cell_sorted = cell[order].contiguous()
    seg_start = torch.searchsorted(cell_sorted, cell_sorted, right=False)
    rank = torch.arange(n, device=dev) - seg_start
    real = cell_sorted < n_cells
    overflow = torch.sum((rank >= capacity) & real)
    ok = (rank < capacity) & real
    flat = torch.where(ok, cell_sorted * capacity + rank,
                       torch.full_like(rank, n_cells * capacity))
    grid = torch.full((n_cells * capacity + 1,), -1, dtype=torch.int64,
                      device=dev).index_put(
        (flat,), torch.where(ok, order, torch.full_like(order, -1)))
    return grid[:-1].reshape(n_cells, capacity), overflow


def _grid_props(x, top, grid, nc, cap):
    """Per-slot positions and properties in the [ncx, ncy, ncz, C] layout;
    empty slots read atom 0 with zero charge and epsilon and unit sigma."""
    valid = grid >= 0
    gi = torch.where(valid, grid, torch.zeros_like(grid))
    shape4 = tuple(nc) + (cap,)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    charges = (top.charges * top.atom_mask).to(x.dtype)
    pos = x[gi].reshape(shape4 + (3,))
    q = torch.where(valid, charges[gi], zero).reshape(shape4)
    sg = torch.where(valid, top.lj_sigma.to(x.dtype)[gi], one).reshape(shape4)
    ep = torch.where(valid, top.lj_eps.to(x.dtype)[gi], zero).reshape(shape4)
    cm = torch.where(valid, top.couple_mask.to(x.dtype)[gi],
                     zero).reshape(shape4)
    return gi, valid, pos, q, sg, ep, cm


def _roll(a, shift):
    return torch.roll(a, (int(shift[0]), int(shift[1]), int(shift[2])),
                      dims=(0, 1, 2))


def make_xla_direct_force_fn(top, cfg, box_extent, x0=None, *,
                             excl: Exclusions):
    """The "window" backend: direct(x, box, couple, beta) ->
    (F [N, 3], e_lj, e_c, overflow), binning x at every call. Same per-pair
    arithmetic as the cell-grid kernel (A&S erfc, softcore, LJ clip),
    without the pairs of `excl` (the topology's exclusion table); forces
    accumulate center-side per shift, energies are half sums.
    `direct.plan` holds (nc, capacity, shifts). The energies are
    differentiable."""
    cutoff = max(cfg.lj_cutoff, cfg.coulomb_cutoff)
    nc, cap, shifts_np = plan_cells(
        box_extent, cutoff, top.n_atoms_real, cfg.cell_capacity_factor,
        x0=x0)
    shifts = [tuple(int(v) for v in s) for s in shifts_np]
    rc2 = cutoff * cutoff
    n = top.n_atoms

    def tile(pos4, q4, s4, e4, c4, m4, id4, box, couple, beta, shift,
             want_force):
        pos_n = _roll(pos4, shift)
        dxv = minimum_image(pos4[..., :, None, :] - pos_n[..., None, :, :],
                            box)
        r2 = torch.sum(dxv * dxv, dim=-1)             # [nx, ny, nz, C, C]
        ok = ((m4[..., :, None] > 0) & (_roll(m4, shift)[..., None, :] > 0)
              & (r2 < rc2) & (r2 > 1e-9)
              & ~excl.excluded(id4[..., :, None],
                               _roll(id4, shift)[..., None, :]))
        r2s = torch.clamp_min(r2, 1e-4)
        inv_r2 = 1.0 / r2s
        sig = 0.5 * (s4[..., :, None] + _roll(s4, shift)[..., None, :])
        eps4x = 4.0 * torch.sqrt(e4[..., :, None]
                                 * _roll(e4, shift)[..., None, :])
        ca = c4[..., :, None]
        cb = _roll(c4, shift)[..., None, :]
        is_alch = ca + cb - 2.0 * ca * cb
        cpl = 1.0 - is_alch * (1.0 - couple)
        a_sc = SOFTCORE_ALPHA * (1.0 - cpl)
        s2 = sig * sig * inv_r2
        s6 = s2 * s2 * s2
        inv_den = 1.0 / (a_sc * s6 + 1.0)
        lj_inv = s6 * inv_den
        e_lj_raw = eps4x * cpl * (lj_inv * lj_inv - lj_inv)
        e_lj = torch.clamp(e_lj_raw, -LJ_CLIP, LJ_CLIP)
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        dlj = eps4x * cpl * (2.0 * lj_inv - 1.0) * (inv_den * inv_den) \
            * (-3.0 * s6 * inv_r2)
        dlj = torch.where(torch.abs(e_lj_raw) < LJ_CLIP, dlj, zero)
        r = torch.sqrt(r2s)
        inv_r = 1.0 / r
        erfc_v, expv = erfc_approx(beta * r)
        kqq = COULOMB_CONST * q4[..., :, None] \
            * _roll(q4, shift)[..., None, :] * cpl
        e_c = kqq * erfc_v * inv_r
        dc = -0.5 * kqq * inv_r2 * (erfc_v * inv_r
                                    + _TWO_OVER_SQRT_PI * beta * expv)
        f = None
        if want_force:
            coeff = torch.where(ok, dlj + dc, zero).detach()
            f = -2.0 * torch.sum(coeff[..., None] * dxv.detach(), dim=-2)
        return (torch.sum(torch.where(ok, e_lj, zero)),
                torch.sum(torch.where(ok, e_c, zero)), f)

    def direct(x, box, couple, beta, want_force=True):
        grid, overflow = bin_atoms(x, box, top.atom_mask, nc, cap)
        gi, valid, pos4, q4, s4, e4, c4 = _grid_props(x, top, grid, nc, cap)
        m4 = valid.to(x.dtype).reshape(q4.shape)
        id4 = gi.reshape(q4.shape)
        e_lj = torch.zeros((), dtype=x.dtype, device=x.device)
        e_c = torch.zeros_like(e_lj)
        f4 = torch.zeros_like(pos4)
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or box.requires_grad)
        for shift in shifts:
            args = (pos4, q4, s4, e4, c4, m4, id4, box, couple, beta, shift,
                    want_force)
            if grad:
                el, ec, f = checkpoint(tile, *args, use_reentrant=False)
            else:
                el, ec, f = tile(*args)
            e_lj = e_lj + el
            e_c = e_c + ec
            if want_force:
                f4 = f4 + f
        f_atoms = None
        if want_force:
            # each real atom occupies one slot; empty slots add zero to
            # atom 0
            f_flat = f4.reshape(-1, 3) * m4.reshape(-1)[:, None]
            f_atoms = torch.zeros((n, 3), dtype=x.dtype,
                                  device=x.device).index_add(
                0, gi.reshape(-1), f_flat)
            f_atoms = f_atoms * top.atom_mask.to(x.dtype)[:, None]
        return f_atoms, 0.5 * e_lj, 0.5 * e_c, overflow

    direct.plan = (nc, cap, shifts_np)
    return direct


def make_cell_direct_space_fn(top, cfg, box_extent, x0=None, *,
                              excl: Exclusions):
    """direct(x, box, couple, ewald_beta) -> (E_lj, E_coul, overflow) over
    the cell grid with exact erfc (pair_lj_coulomb), without the excluded
    and 1-4 pairs of `excl` (the topology's exclusion table). `overflow`
    counts atoms dropped from the binning; nonzero means the energies are
    wrong and the capacity must grow."""
    cutoff = max(cfg.lj_cutoff, cfg.coulomb_cutoff)
    nc, cap, shifts_np = plan_cells(
        box_extent, cutoff, top.n_atoms_real, cfg.cell_capacity_factor,
        x0=x0)
    shifts = [tuple(int(v) for v in s) for s in shifts_np]

    def pair_block_energy(r2, qi, qj, si, sj, ei, ej, cmi, cmj, couple,
                          ewald_beta, valid):
        sig, eps = lorentz_berthelot(si, sj, ei, ej)
        is_alch = cmi + cmj - 2.0 * cmi * cmj
        cpl = 1.0 - is_alch * (1.0 - couple)
        e_lj, e_c = pair_lj_coulomb(
            r2, qi * qj, sig, eps, cpl, ewald_beta=ewald_beta,
            cutoff=cfg.lj_cutoff, lj_switch_start=cfg.lj_switch_start,
            coulomb_cutoff=cfg.coulomb_cutoff)
        zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
        return (torch.sum(torch.where(valid, e_lj, zero)),
                torch.sum(torch.where(valid, e_c, zero)))

    def tile(pos4, q4, s4, e4, c4, id4, box, couple, ewald_beta, shift):
        pos_n = _roll(pos4, shift)
        dxv = minimum_image(pos4[..., :, None, :] - pos_n[..., None, :, :],
                            box)
        r2 = torch.sum(dxv * dxv, dim=-1)
        idn = _roll(id4, shift)
        ok = ((id4[..., :, None] >= 0) & (idn[..., None, :] >= 0)
              & (id4[..., :, None] != idn[..., None, :])
              & ~excl.excluded(id4[..., :, None], idn[..., None, :]))
        return pair_block_energy(
            r2, q4[..., :, None], _roll(q4, shift)[..., None, :],
            s4[..., :, None], _roll(s4, shift)[..., None, :],
            e4[..., :, None], _roll(e4, shift)[..., None, :],
            c4[..., :, None], _roll(c4, shift)[..., None, :],
            couple, ewald_beta, ok)

    def direct(x, box, couple, ewald_beta):
        grid, overflow = bin_atoms(x, box, top.atom_mask, nc, cap)
        gi, valid, pos4, q4, s4, e4, c4 = _grid_props(x, top, grid, nc, cap)
        id4 = torch.where(valid, grid, torch.full_like(grid, -1)).reshape(
            q4.shape)
        e_lj = torch.zeros((), dtype=x.dtype, device=x.device)
        e_c = torch.zeros_like(e_lj)
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or box.requires_grad)
        for shift in shifts:
            args = (pos4, q4, s4, e4, c4, id4, box, couple, ewald_beta,
                    shift)
            el, ec = (checkpoint(tile, *args, use_reentrant=False) if grad
                      else tile(*args))
            e_lj = e_lj + el
            e_c = e_c + ec
        # each pair visited twice
        return 0.5 * e_lj, 0.5 * e_c, overflow

    direct.plan = (nc, cap, shifts_np)
    return direct
