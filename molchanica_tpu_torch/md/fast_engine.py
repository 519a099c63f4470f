"""FastSim: the sorted-state MD engine around the colpair kernel (port of
molchanica_tpu.md.fast_engine).

The dynamic state lives in column-sorted slot order (ops/colpair.py):

  period = [ rebuild (anchor sort + window tables + index remap) ]
           -> k steps of
                vsites -> colpair kernels + PME + bonded + exclusion
                subtraction -> Langevin-middle / Verlet -> SETTLE + H-SHAKE

A period is one Python loop over k = neighbor_rebuild_every steps on
torch tensors. A coupled solute (topology couple_mask) runs the has_alch
colpair kernels at the state's `couple`; `configure_alchemical_window`
sets it and `dhdl` differentiates the energy in it. `minimize` is the
capped steepest-descent clash relaxation that init runs when no
velocities are given. With a rigid multi-site water the direct sum runs as two
triangular kernels over two overlapping subsets (the species split, see
__init__); `triangular=False` (or MOLCHANICA_FASTSIM_TRI=0) runs it as one
symmetric kernel over the master tables instead. Hot periods apply the
reciprocal-space force as an r-RESPA impulse every second step. With a
barostat each period ends with a Berendsen scaling of the molecules and
the box (md/barostat.py); drift past 3% of the planned box replans.
`run` steps in snapshot intervals and records a Snapshot after each. Index
arrays that the reference reads at a pad slot S (JAX clamps gathers) are
clamped to S - 1 here; the masks zero what they read.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..constants import ACCEL_FACTOR, COULOMB_CONST, KB
from ..device import resolve_device
from ..ops.bonded import angle_energy, bond_energy, dihedral_energy
from ..ops.colpair import (ICL, PER_SLICE_K, R2_MIN, ZBITS, ColpairDirect,
                           make_anchor_sort_fn, make_window_fn,
                           pairlist_colpair_energy, plan_columns)
from ..ops.nonbonded import intramol_pairs_np
from ..ops.pbc import minimum_image
from ..ops.pme import ewald_beta_for
from ..ops.pme3 import default_grid6, make_pme3_recip_fn
from ..topology import Topology
from .config import MdConfig
from .integrators import make_integrator_step
from .settle import (settle_compute_rolled, settle_params,
                     settle_velocities_rolled)
from .state import init_velocities, kinetic_energy, remove_com_drift


def _solve3(A, b):
    """Closed-form batched 3x3 solve by Cramer's rule ([C,3,3] x [C,3])."""
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2]
    c1 = a22 * a33 - a23 * a32
    c2 = a23 * a31 - a21 * a33
    c3 = a21 * a32 - a22 * a31
    det = a11 * c1 + a12 * c2 + a13 * c3
    inv = 1.0 / torch.where(torch.abs(det) < 1e-12, torch.ones_like(det),
                            det)
    x1 = (b1 * c1 + a12 * (a23 * b3 - b2 * a33)
          + a13 * (b2 * a32 - a22 * b3)) * inv
    x2 = (a11 * (b2 * a33 - a23 * b3) + b1 * c2
          + a13 * (a21 * b3 - b2 * a31)) * inv
    x3 = (a11 * (a22 * b3 - b2 * a32) + a12 * (b2 * a31 - a21 * b3)
          + b1 * c3) * inv
    return torch.stack([x1, x2, x3], dim=-1)


class NonFiniteEnergyError(RuntimeError):
    """Non-finite energy after a step call: an instability."""


class _BoxDriftReplan(Exception):
    """NPT box drift past the plan's tolerance: the dynamics up to the
    drift check are valid; step() replans at the current box and
    continues the remainder."""

    def __init__(self, steps_done: int):
        super().__init__(steps_done)
        self.steps_done = steps_done


class ColpairOverflowError(RuntimeError):
    """A rebuild exceeded a planned table capacity (window slice entries or
    sort columns). step() restores the last good state, replans (doubling
    the per-slice window capacity only when the window tables overflowed)
    and resumes; callers see this only when the retry budget runs out, or
    at once when range tables (per_slice_k = 0) overflow: they cannot
    widen."""

    def __init__(self, msg, good_state=None, steps_good=0, elen_good=0,
                 window=True):
        super().__init__(msg)
        self.good_state = good_state
        self.steps_good = steps_good
        self.elen_good = elen_good
        self.window = window


@dataclass
class FastState:
    """Everything that changes during a run, in sorted-slot order [S].
    Tensors are replaced, never updated in place, so an old state stays a
    valid restore point."""
    perm: torch.Tensor       # [S] slot -> base atom id (n_base = dummy)
    x: torch.Tensor          # [S, 3]
    v: torch.Tensor          # [S, 3]
    props: torch.Tensor      # [S, 5] (q sqrt(kC), sigma/2, 2 sqrt(eps),
                             #         couple_mask, group id + 1)
    masses: torch.Tensor     # [S]
    dof: torch.Tensor        # [S]
    wl: Optional[torch.Tensor]  # [NC, 3K] window entries (monolithic path)
    nw: Optional[torch.Tensor]  # [NC]
    bond_idx: torch.Tensor   # gather indices, clamped to S - 1
    angle_idx: torch.Tensor
    dihedral_idx: torch.Tensor
    excl_idx: torch.Tensor
    p14_idx: torch.Tensor
    intra_idx: torch.Tensor  # [P, 2] coupled-molecule internal pairs
    hc_idx: torch.Tensor     # [C, 4] heavy + 3 H; pads at S (tables)
    # per-slot ownership tables, rebuilt with the sort:
    w_of: torch.Tensor       # water row owning this slot (NW = none)
    w_role: torch.Tensor     # 0=O 1=H1 2=H2 within that water, -1 = none
    vm_of: torch.Tensor      # vsite row whose M site is this slot (V = none)
    hc_of: torch.Tensor      # H-cluster row owning this slot (C = none)
    hc_role: torch.Tensor    # 0=heavy 1..3=H member, -1 = none
    # species-split subset tables ({} when the split is off): idx_*/props_*
    # the subset gathers and kernel props, wl_*/nw_* the subset windows,
    # gsrc_* the [S] merge gathers into concat(f_L, f_Q, zero row)
    split: dict
    f: torch.Tensor          # [S, 3] force at x (carried across periods)
    box: torch.Tensor        # [3]
    couple: torch.Tensor     # scalar
    step: int
    overflow: torch.Tensor   # accumulated bit-packed overflow flag
    pe_last: torch.Tensor
    ke_last: torch.Tensor

    def replace(self, **kw) -> "FastState":
        return dataclasses.replace(self, **kw)


def _np(t):
    return t.detach().cpu().numpy()


class FastSim:
    """Sorted-state MD engine for periodic systems, on `device` (the CUDA
    card unless the caller asks for the CPU).

    triangular: the direct-space table. True evaluates every unordered
    pair once (the species split where it applies, else one triangular
    kernel); False the symmetric table, one kernel over the master tables
    that evaluates every ordered pair from its i side. None reads
    MOLCHANICA_FASTSIM_TRI ("1", the default, is triangular), as the
    reference does."""

    def __init__(self, top: Topology, cfg: MdConfig, x0, box_extent,
                 velocities=None, per_slice_k=None, device="cuda",
                 generator: torch.Generator = None, triangular=None):
        dev = resolve_device(device)
        self.device = dev
        if box_extent is None:
            raise ValueError("FastSim requires a periodic box")
        if cfg.dtype != "float32":
            raise ValueError("FastSim is a float32 engine")
        tri = (os.environ.get("MOLCHANICA_FASTSIM_TRI", "1") == "1"
               if triangular is None else bool(triangular))
        self._tri = tri
        if dev.type == "cuda":
            # PME's products are float32 matmuls: keep them in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.top = top
        self.cfg = cfg
        self.n_base = n_base = top.n_atoms
        f32 = dict(dtype=torch.float32, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)
        T = lambda a, **kw: torch.as_tensor(np.asarray(a), **(kw or f32))
        charges = _np(top.charges)
        atom_mask = _np(top.atom_mask)
        couple_mask = _np(top.couple_mask)
        self._has_alch = has_alch = bool(couple_mask.sum() > 0)
        box_np = np.asarray(box_extent, np.float64)
        rc = float(max(cfg.lj_cutoff, cfg.coulomb_cutoff))
        self.beta = float(ewald_beta_for(cfg.coulomb_cutoff, cfg.ewald_rtol))
        # Blocked-water layout: every water's sites inherit the O's sort
        # key, so each water is a contiguous (O, H1, H2[, M]) slot block
        # through every rebuild (SETTLE, vsites and intra-water corrections
        # then run by torch.roll). Window selection reaches r_blob further.
        self._ws = int(top.water_start)
        self._wstride = int(top.water_site_count)
        self._n_wsites = int(top.water_count) * self._wstride
        r_blob = float(top.water_r_oh) if top.water_count > 0 else 0.0
        # skin 1.2 A unless the box cannot fit 3 columns at that reach
        # (small test boxes); never below 0.25
        skin = min(1.2, float(box_np.min()) / 3.0 - rc - 2.0 * r_blob - 1e-6)
        if skin < 0.25 - 1e-9:
            raise ValueError(f"box {box_np} too small for FastSim at "
                             f"cutoff {rc}")
        self.plan = plan_columns(box_np, rc, self.beta, top.n_atoms_real,
                                 n_base, skin=skin, r_blob=r_blob)
        self._box0 = box_np.copy()       # the plan's box (NPT drift check)
        S = self.plan.n_sorted
        self.S = S

        # ---- base (original-order) arrays + dummy row at n_base ----
        def with_dummy(a, fill):
            a = np.asarray(a)
            d = np.full((1,) + a.shape[1:], fill, a.dtype)
            return np.concatenate([a, d], axis=0)

        q = charges.astype(np.float64) * atom_mask
        # exclusion-group ids (kernel props col 7): a water's sites share
        # one id, so the kernel masks all intra-water pairs; other atoms get
        # unique ids; 0 marks padded slots
        gid = np.arange(n_base, dtype=np.float64)
        if self._n_wsites:
            wi = np.arange(self._n_wsites)
            gid[self._ws:self._ws + self._n_wsites] = \
                self._ws + self._wstride * (wi // self._wstride)
        props_base = np.stack([
            q * np.sqrt(COULOMB_CONST),
            _np(top.lj_sigma) / 2.0,
            2.0 * np.sqrt(_np(top.lj_eps)),
            couple_mask,
            (gid + 1.0) * atom_mask], axis=1).astype(np.float32)
        self._props_base = T(with_dummy(props_base, 0.0))
        self._masses_base = T(with_dummy(_np(top.masses), 1.0))
        self._dof_base = T(with_dummy(_np(top.dof_mask), 0.0))
        self.n_waters = int(top.water_count)
        if self.n_waters:
            o = top.water_start + self._wstride * np.arange(self.n_waters)
            widx_base = np.stack([o, o + 1, o + 2], axis=1)
        else:
            widx_base = np.full((1, 3), n_base)
        self._widx_base = T(widx_base, **i64)

        # solute H clusters (waters are SETTLE's)
        hc_heavy = _np(top.hcluster_heavy)
        hc_h = _np(top.hcluster_h)
        hc_r0 = _np(top.hcluster_r0)
        keep = (hc_h >= 0).any(axis=1)
        self._use_hshake = (cfg.hydrogen_constraint.kind != "flexible"
                            and bool(keep.any()))
        if self._use_hshake:
            hh = hc_h[keep]
            hc_idx = np.concatenate(
                [hc_heavy[keep][:, None], np.where(hh < 0, n_base, hh)],
                axis=1)
            self._hc_mask = T((hh >= 0).astype(np.float32))
            self._hc_r0 = T(np.where(hh >= 0, hc_r0[keep], 1.0))
            hmass = _np(top.masses)
            inv_m = np.zeros((hc_idx.shape[0], 4), np.float32)
            inv_m[:, 0] = 1.0 / hmass[hc_idx[:, 0]]
            for k in range(3):
                hk = hh[:, k]
                inv_m[:, k + 1] = np.where(
                    hk >= 0, 1.0 / hmass[np.clip(hk, 0, n_base - 1)], 0.0)
            self._hc_invm = T(inv_m)
            self._hc_idx_base = T(hc_idx, **i64)
            self.n_h_constraints = int((hh >= 0).sum())
        else:
            self._hc_idx_base = T(np.full((1, 4), n_base), **i64)
            self._hc_mask = torch.zeros((1, 3), **f32)
            self._hc_r0 = torch.ones((1, 3), **f32)
            self._hc_invm = torch.zeros((1, 4), **f32)
            self.n_h_constraints = 0
        self.n_constraints = 3 * self.n_waters + self.n_h_constraints

        # vsites: only the blocked 4-site-water layout (M = O + 3 in the
        # block, one shared weight), applied and spread by torch.roll
        vs = _np(top.vsite_idx)
        vmask = _np(top.vsite_mask) > 0
        self._has_vsites = bool(vmask.any())
        self._vs_w = 0.0
        if self._has_vsites:
            vw = _np(top.vsite_weight)[vmask]
            vv = vs[vmask]
            rolled = bool(
                self._wstride == 4
                and vv.shape[0] == top.water_count
                and (vv[:, 0] == vv[:, 1] + 3).all()
                and (vv[:, 2] == vv[:, 1] + 1).all()
                and (vv[:, 3] == vv[:, 1] + 2).all()
                and ((vv[:, 1] - self._ws) % 4 == 0).all()
                and np.allclose(vw, vw[0]))
            if not rolled:
                raise NotImplementedError(
                    "FastSim virtual sites must be blocked 4-site-water M "
                    "sites with one shared weight")
            self._vs_w = float(vw[0])
            self._vs_base = T(np.where(vmask[:, None], vs, n_base), **i64)
        else:
            self._vs_base = T(np.full((1, 4), n_base), **i64)

        self._settle_geom = (settle_params(top.water_r_oh,
                                           top.water_theta_hoh, 15.999,
                                           1.008)
                             if self.n_waters else (0.1, 0.1, 0.1))

        # 1-4 scale divisors (per pair row)
        self._p14_scee = T(1.0 / np.maximum(_np(top.pair14_scee), 1e-6))
        self._p14_scnb = T(1.0 / np.maximum(_np(top.pair14_scnb), 1e-6))
        self._p14_mask = top.pair14_mask.to(dev)
        self._bonded = {k: getattr(top, k).to(dev) for k in (
            "bond_k", "bond_r0", "angle_k", "angle_theta0", "dihedral_k",
            "dihedral_n", "dihedral_phase", "bond_idx", "angle_idx",
            "dihedral_idx", "pair14_idx")}

        # water intra pairs are masked in the kernel (shared group id) and
        # their reciprocal-space erf compensation runs by rolls: drop them
        # from the pair-list exclusion set
        excl_np = _np(top.excl_idx)
        exm_np = _np(top.excl_mask).astype(np.float32)
        if self._n_wsites:
            lo, hi = self._ws, self._ws + self._n_wsites
            in_w = ((excl_np[:, 0] >= lo) & (excl_np[:, 0] < hi)
                    & (excl_np[:, 1] >= lo) & (excl_np[:, 1] < hi))
            keep = ~(in_w & (exm_np > 0))
            if not keep.any():
                keep[0] = True          # fixed nonzero shape
            excl_np = excl_np[keep]
            exm_np = exm_np[keep] * (~in_w[keep])
            self._wq = [float(v) for v in
                        charges[self._ws:self._ws + self._wstride]]
            if (couple_mask[lo:hi] > 0).any():
                raise ValueError(
                    "alchemically coupled waters are unsupported by FastSim")
        else:
            self._wq = []
        self._excl_idx_base = T(excl_np, **i64)
        self._excl_mask = T(exm_np)
        # couple-intramol=no compensation pairs of the coupled molecule
        im_idx, im_mask = intramol_pairs_np(top)
        self._im_idx_base = T(im_idx, **i64)
        self._im_mask = T(im_mask)

        # PME: order-6 splines on a ~1.3 A mesh, matmul DFT, analytic
        # gradient (the box gradient is zero: FastSim never needs it)
        grid = cfg.pme_grid or default_grid6(box_np, self.beta)
        self._recip = make_pme3_recip_fn(grid, self.beta, device=dev)

        # window tables: per-slice with per_slice_k entries per cluster, or
        # at per_slice_k = 0 range tables of plan.w_max entries, whose
        # kernels walk the slices of each range
        psk = PER_SLICE_K if per_slice_k is None else int(per_slice_k)
        self._psk = psk
        rt = psk == 0
        # the monolithic kernel: the direct sum when the species split does
        # not apply (no water, no LJ/charge role split, or symmetric tables)
        self._direct = {we: ColpairDirect(self.plan, want_energy=we,
                                          has_alch=has_alch, range_tables=rt,
                                          triangular=tri)
                        for we in (True, False)}

        # ---- species-split direct path ----
        # In a rigid multi-site water the interaction roles factor: OPC's O
        # carries only LJ (q = 0) and its H/M sites only charge (eps = 0).
        # Split the direct sum into two triangular kernels over two
        # overlapping subsets:
        #   L = water LJ sites + all solute atoms, full LJ + Coulomb math;
        #   Q = water charge sites + all solute atoms, Coulomb only, with
        #       solute-solute pairs filtered (L owns them) by the water
        #       group-id range.
        # O-H/M pairs never meet: they do not interact.
        self._split = None
        if tri and self._n_wsites:
            wst = self._wstride
            weps = _np(top.lj_eps)[self._ws:self._ws + wst]
            wq_r = charges[self._ws:self._ws + wst]
            lj_roles = [r for r in range(wst) if weps[r] > 0]
            q_roles = [r for r in range(wst) if abs(wq_r[r]) > 1e-12]
            if (lj_roles and q_roles
                    and not set(lj_roles) & set(q_roles)):
                idx_b = np.arange(n_base)
                in_w_b = ((idx_b >= self._ws)
                          & (idx_b < self._ws + self._n_wsites))
                role_b = np.where(in_w_b, (idx_b - self._ws) % wst, -1)
                amask_b = atom_mask > 0
                in_sol = (~in_w_b) & amask_b
                has_solute = bool(in_sol.sum() > 0)
                in_L = (np.isin(role_b, lj_roles) & amask_b) | in_sol
                in_Q = (np.isin(role_b, q_roles) & amask_b) | in_sol
                n_cols = self.plan.n_cols

                def sub_size(n):
                    cap = int(n) + ICL * n_cols
                    return ((cap + 127) // 128) * 128

                S_L = sub_size(in_L.sum())
                S_Q = sub_size(in_Q.sum())
                # L keys: O sites and solute atoms key by their own
                # positions, so L needs no blob margin
                plan_L = dataclasses.replace(self.plan, n_sorted=S_L,
                                             r_blob=0.0)
                plan_Q = dataclasses.replace(self.plan, n_sorted=S_Q)
                wfilt = ((float(self._ws + 1),
                          float(self._ws + self._n_wsites + 1))
                         if has_solute else None)
                mode_L = "full" if has_solute else "lj"
                kernels = {we: dict(
                    L=ColpairDirect(plan_L, want_energy=we, mode=mode_L,
                                    has_alch=has_alch, range_tables=rt),
                    Q=ColpairDirect(plan_Q, want_energy=we, mode="coul",
                                    water_filter=wfilt, has_alch=has_alch,
                                    range_tables=rt))
                    for we in (True, False)}
                self._split = dict(
                    S_L=S_L, S_Q=S_Q, plan_L=plan_L, plan_Q=plan_Q,
                    in_L_ext=T(np.append(in_L, False), dtype=torch.bool,
                               device=dev),
                    in_Q_ext=T(np.append(in_Q, False), dtype=torch.bool,
                               device=dev),
                    kernels=kernels,
                    win_L=make_window_fn(plan_L, per_slice_k=psk),
                    win_Q=make_window_fn(plan_Q, per_slice_k=psk))

        # anchor sort: one key per water block / free atom
        if self._n_wsites:
            wc = top.water_count
            anchor_ids = np.concatenate([
                np.arange(0, self._ws),
                self._ws + self._wstride * np.arange(wc),
                np.arange(self._ws + self._n_wsites, n_base)])
            sizes = np.concatenate([
                np.ones(self._ws, np.int64),
                np.full(wc, self._wstride, np.int64),
                np.ones(n_base - self._ws - self._n_wsites, np.int64)])
        else:
            anchor_ids = np.arange(n_base)
            sizes = np.ones(n_base, np.int64)
        self._anchor_sort = make_anchor_sort_fn(
            self.plan, anchor_ids, sizes, atom_mask, device=dev)
        self._windows = (make_window_fn(self.plan, per_slice_k=psk,
                                        triangular=tri)
                         if self._split is None else None)
        # base-order helpers for the molecule-frame wrap
        idx_b = np.arange(n_base)
        in_w_b = (idx_b >= self._ws) & (idx_b < self._ws + self._n_wsites)
        role_b = np.where(in_w_b, (idx_b - self._ws) % max(self._wstride, 1),
                          0)
        self._in_w_base = T(in_w_b, dtype=torch.bool, device=dev)
        self._owner_base = T(idx_b - role_b, **i64)
        # molecule of each base id, the dummy row its own molecule n_mol
        # (the barostat's COM scaling)
        self._n_mol = int(top.n_mol)
        self._mol_b = T(np.append(_np(top.mol_id), self._n_mol), **i64)

        # ---- initial state: identity layout, then one rebuild ----
        self.force_evals = 0        # force evaluations, carried by _replan
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(int(cfg.seed))
        self.generator = generator
        x0_np = np.asarray(x0, np.float32)
        if x0_np.shape != (n_base, 3):
            raise ValueError(f"x0 has shape {x0_np.shape}, the topology "
                             f"{(n_base, 3)}")
        pad = S - n_base
        x_init = np.concatenate(
            [x0_np, np.full((pad, 3), 1.0e6, np.float32)], axis=0)
        if velocities is None:
            v0 = init_velocities(generator, top.masses.to(dev),
                                 top.dof_mask.to(dev), cfg.temp_target)
        else:
            v0 = T(np.asarray(velocities, np.float32))
        perm_init = torch.cat([torch.arange(n_base, **i64),
                               torch.full((pad,), n_base, **i64)])
        zero_f = torch.zeros((), **f32)
        state = FastState(
            split={}, perm=perm_init, x=T(x_init),
            v=torch.cat([v0, torch.zeros((pad, 3), **f32)]),
            props=self._props_base[perm_init],
            masses=self._masses_base[perm_init],
            dof=self._dof_base[perm_init], wl=None, nw=None,
            bond_idx=None, angle_idx=None, dihedral_idx=None, excl_idx=None,
            p14_idx=None, intra_idx=None, hc_idx=self._hc_idx_base,
            f=torch.zeros((S, 3), **f32), box=T(box_np),
            couple=torch.ones((), **f32), step=0,
            overflow=torch.zeros((), **i64), pe_last=zero_f,
            ke_last=zero_f,
            **self._merge_tables(self._widx_base, self._vs_base,
                                 self._hc_idx_base))
        with torch.no_grad():
            state = self._rebuild(state)
            # project onto the constraint manifold, then seed the carried
            # force (each step does one force evaluation)
            cp, _ = self._make_cp_cv()
            if cp is not None:
                state = state.replace(x=cp(state.x, state.x, state))
            f0, (e0, _t) = self._make_force_fn()(state.x, state)
        self.state = state.replace(f=f0, pe_last=e0)
        self._wall_time = 0.0
        self._sim_time_ps = 0.0
        self._last_terms = {}
        self._last_pressure = None
        # (step, pressure bar, box x A) after each barostat period
        self.pressure_log: list = []
        self.snapshots: list = []
        # the reference's init relaxation (max_init_relaxation_iters),
        # skipped when the caller supplies velocities (restart / replan)
        if velocities is None and cfg.max_init_relaxation_iters:
            self.minimize(int(cfg.max_init_relaxation_iters))

    # ------------------------------------------------------------------
    def _merge_tables(self, widx, vsite_idx, hc_idx):
        """[S] tables mapping each slot to the row that owns it and its
        member role. Slot S is a sink for pad rows and is dropped."""
        S = self.S

        def tables(idx, roles):
            R, k = idx.shape
            dev = idx.device
            of = torch.full((S + 1,), R, dtype=torch.int64, device=dev)
            rl = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
            slots = torch.clamp(idx.reshape(-1), 0, S)
            of[slots] = torch.arange(R, device=dev).repeat_interleave(k)
            rl[slots] = torch.tensor(roles, device=dev).repeat(R)
            return of[:S], rl[:S]

        w_of, w_role = tables(widx, [0, 1, 2])
        vm_of, _ = tables(vsite_idx[:, 0:1], [0])
        hc_of, hc_role = tables(hc_idx, [0, 1, 2, 3])
        return dict(w_of=w_of, w_role=w_role, vm_of=vm_of,
                    hc_of=hc_of, hc_role=hc_role)

    # ------------------------------------------------------------------
    def _subset_tables(self, perm_new, keys, col_start, x_new, props_new,
                       box):
        """Species-split subset arrays derived from the master sort: each
        subset keeps the master's per-column order with its own column
        runs padded to ICL. Returns the split dict plus the column and
        window overflows."""
        spc = self._split
        S = self.S
        dev = x_new.device
        n_cols = self.plan.n_cols
        zmaxv = (1 << ZBITS) - 1
        ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
        slot_col = torch.clamp_max(torch.searchsorted(
            col_start[1:].contiguous(), ar(S), right=True), n_cols - 1)
        x_ext = torch.cat([x_new, torch.full((1, 3), 1.0e6,
                                             dtype=x_new.dtype, device=dev)])
        keys_ext = torch.cat([keys, torch.zeros_like(keys[:1])])
        props_ext = torch.cat([props_new, torch.zeros_like(props_new[:1])])
        col_start_c = torch.clamp_max(col_start, S)

        def build(in_ext, S_sub):
            # the k-th member of column c sits at the master slot where the
            # membership cumsum first reaches its rank
            m = in_ext[perm_new]                     # [S]; pads -> False
            mi = m.long()
            mcum = torch.cumsum(mi, 0)               # inclusive
            me = mcum - mi                           # exclusive
            nb = torch.cat([me, mcum[-1:]])[col_start_c]
            cnt = nb[1:] - nb[:-1]
            cs = torch.cat([torch.zeros_like(cnt[:1]),
                            torch.cumsum(((cnt + ICL - 1) // ICL) * ICL, 0)])
            ovf = torch.clamp_min(cs[-1] - S_sub, 0)
            tt = ar(S_sub)
            sub_col = torch.clamp_max(torch.searchsorted(
                cs[1:].contiguous(), tt, right=True), n_cols - 1)
            r_in = tt - cs[sub_col]
            valid = r_in < cnt[sub_col]
            found = torch.searchsorted(mcum, nb[sub_col] + r_in + 1)
            idx = torch.where(valid, torch.clamp_max(found, S - 1),
                              torch.full_like(found, S))
            kk = torch.where(valid, keys_ext[idx],
                             (sub_col << ZBITS) | zmaxv)
            # master slot -> subset row (for the force merge), -1 = absent
            gs = torch.where(m, cs[slot_col] + (me - nb[slot_col]),
                             torch.full_like(me, -1))
            return idx, kk, ovf, gs

        idx_l, keys_l, ov1, gs_l = build(spc["in_L_ext"], spc["S_L"])
        idx_q, keys_q, ov2, gs_q = build(spc["in_Q_ext"], spc["S_Q"])
        props_l = props_ext[idx_l]
        props_q = props_ext[idx_q]
        wl_l, nw_l, ov3 = spc["win_L"](x_ext[idx_l], keys_l, box,
                                       props_l[:, 4])
        wl_q, nw_q, ov4 = spc["win_Q"](x_ext[idx_q], keys_q, box,
                                       props_q[:, 4])
        # merge gathers: master slot -> its row(s) in concat(fL, fQ, 0-row);
        # solute atoms live in both subsets and their halves add
        zrow = spc["S_L"] + spc["S_Q"]
        zr = torch.full_like(gs_l, zrow)
        sp = dict(idx_l=idx_l, props_l=props_l, wl_l=wl_l, nw_l=nw_l,
                  idx_q=idx_q, props_q=props_q, wl_q=wl_q, nw_q=nw_q,
                  gsrc_l=torch.where(gs_l >= 0, gs_l, zr),
                  gsrc_q=torch.where(gs_q >= 0, spc["S_L"] + gs_q, zr))
        return sp, ov1 + ov2, ov3 + ov4

    # ------------------------------------------------------------------
    def _to_base(self, st: FastState, a, fill):
        """A sorted [S, 3] array in base order [n_base, 3]."""
        out = torch.full((self.n_base + 1, 3), fill, dtype=a.dtype,
                         device=a.device)
        out[st.perm] = a                   # pads land in the sink n_base
        return out[:self.n_base]

    def _sort(self, st: FastState):
        """The master anchor sort of st's positions, as the rebuild makes
        it: (perm, keys, col_start, overflow, sorted x [S, 3], sorted
        props [S, 5]). Works in base order: the positions (vsites
        refreshed) are scattered back to base ids and wrapped by molecule
        there."""
        # vsites are never moved by the integrator: refresh them from their
        # parents before sorting
        xb = self._to_base(st, self._apply_vsites(st.x, st.vm_of, st.box),
                           1.0e6)
        box = st.box
        xw = xb - box * torch.floor(xb / box)             # per-atom wrap
        if self._n_wsites:
            # wrap waters as molecules in the O's frame: the kernel's baked
            # window shifts assume every stored coordinate lies in the
            # column claimed by its (O-inherited) key
            rel = minimum_image(xb - xb[self._owner_base], box)
            xw = torch.where(self._in_w_base[:, None],
                             xw[self._owner_base] + rel, xw)
        perm_new, keys, col_start, ovf = self._anchor_sort(xw, box)
        x_new = torch.cat([xw, torch.full((1, 3), 1.0e6, dtype=xw.dtype,
                                          device=xw.device)])[perm_new]
        return (perm_new, keys, col_start, ovf, x_new,
                self._props_base[perm_new])

    def _rebuild(self, st: FastState) -> FastState:
        """Re-sort by column (anchor-based), regather, remap, rebuild the
        window tables. Every index array is re-derived from the static
        base arrays."""
        S = self.S
        n_base = self.n_base
        dev = st.x.device
        box = st.box
        perm_new, keys, col_start, ovf1, x_new, props_new = self._sort(st)
        vb = self._to_base(st, st.v, 0.0)
        fb = self._to_base(st, st.f, 0.0)
        pad_row = lambda a, v: torch.cat(
            [a, torch.full((1, 3), v, dtype=a.dtype, device=dev)])
        # base id -> new slot; dummy and base pads -> S. The dummy entry is
        # overwritten after the scatter that may have written it.
        inv = torch.full((n_base + 1,), S, dtype=torch.int64, device=dev)
        inv[perm_new] = torch.arange(S, dtype=torch.int64, device=dev)
        inv[n_base] = S

        def remap(idx):
            return inv[torch.clamp(idx, 0, n_base)]

        def gather_idx(idx):
            return torch.clamp_max(remap(idx), S - 1)

        bp = self._bonded
        widx_new = remap(self._widx_base)
        vsite_new = remap(self._vs_base)
        hc_new = remap(self._hc_idx_base)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        if self._split is not None:
            sp, ovf3c, ovf3w = self._subset_tables(
                perm_new, keys, col_start, x_new, props_new, box)
            wl = nw = None
        else:
            sp, ovf3c = {}, zero
            wl, nw, ovf3w = self._windows(x_new, keys, box, props_new[:, 4])
        # two overflow sources, bit-packed so recovery can tell them apart:
        # low 15 bits column capacity, high bits window-slice tables
        ovf = (torch.clamp_max(ovf1 + ovf3c, 0x7FFF)
               + (torch.clamp_max(ovf3w, 0x7FFF) << 15))
        return st.replace(
            split=sp, perm=perm_new, x=x_new,
            v=pad_row(vb, 0.0)[perm_new], f=pad_row(fb, 0.0)[perm_new],
            props=props_new, masses=self._masses_base[perm_new],
            dof=self._dof_base[perm_new], wl=wl, nw=nw,
            bond_idx=gather_idx(bp["bond_idx"]),
            angle_idx=gather_idx(bp["angle_idx"]),
            dihedral_idx=gather_idx(bp["dihedral_idx"]),
            excl_idx=gather_idx(self._excl_idx_base),
            p14_idx=gather_idx(bp["pair14_idx"]),
            intra_idx=gather_idx(self._im_idx_base),
            hc_idx=hc_new, overflow=st.overflow | ovf,
            **self._merge_tables(widx_new, vsite_new, hc_new))

    # ------------------------------------------------------------------
    # Vsites on the blocked layout: O at M-3, H1 at M-2, H2 at M-1. The M
    # position is computed "as if every slot were an O", shifted +3 onto
    # the M slots and masked in; the M force goes back the same way.
    def _apply_vsites(self, x, vm_of, box):
        if not self._has_vsites:
            return x
        w = self._vs_w
        d1 = minimum_image(torch.roll(x, -1, 0) - x, box)
        d2 = minimum_image(torch.roll(x, -2, 0) - x, box)
        xm = x + w * (d1 + d2)
        m_m = (vm_of < self._vs_base.shape[0])[:, None]
        return torch.where(m_m, torch.roll(xm, 3, 0), x)

    def _spread_vsite_forces(self, f, vm_of):
        if not self._has_vsites:
            return f
        w = self._vs_w
        m_m = (vm_of < self._vs_base.shape[0])[:, None]
        zero = torch.zeros_like(f)
        add = (torch.where(torch.roll(m_m, -3, 0),
                           (1.0 - 2.0 * w) * torch.roll(f, -3, 0), zero)
               + torch.where(torch.roll(m_m, -2, 0),
                             w * torch.roll(f, -2, 0), zero)
               + torch.where(torch.roll(m_m, -1, 0),
                             w * torch.roll(f, -1, 0), zero))
        return torch.where(m_m, zero, f + add)

    # ------------------------------------------------------------------
    def _direct_force(self, x_v, st: FastState, want_energy):
        """The direct-space colpair sum at positions x_v (vsites refreshed)
        on st's tables: (f [S, 3] in master slot order, e_lj, e_c), the
        species split's L and Q kernels merged, or the monolithic kernel."""
        box, couple = st.box, st.couple
        if self._split is None:
            rows = torch.cat([x_v, st.props], 1)
            return self._direct[bool(want_energy)](
                rows, rows.T.contiguous(), st.wl, st.nw, box, couple)
        skern = self._split["kernels"][bool(want_energy)]
        sp = st.split
        x_ext = torch.cat([x_v, torch.full((1, 3), 1.0e6, dtype=x_v.dtype,
                                           device=x_v.device)])
        out = []
        for key in ("l", "q"):
            rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
            out.append(skern[key.upper()](rows, rows.T.contiguous(),
                                          sp[f"wl_{key}"], sp[f"nw_{key}"],
                                          box, couple))
        (f_l, elj_l, ec_l), (f_q, elj_q, ec_q) = out
        comb = torch.cat([f_l, f_q, torch.zeros_like(f_l[:1])])
        return (comb[sp["gsrc_l"]] + comb[sp["gsrc_q"]], elj_l + elj_q,
                ec_l + ec_q)

    def _make_force_fn(self, want_energy=True, recip_weight=1.0):
        """force(x, st) -> (f, (e, terms)). Index arrays come from `st`.

        recip_weight multiplies the reciprocal-space force: 1 on the plain
        path, 0 / 2 on alternating steps of the impulse-MTS hot path. The
        recip gradient comes from the analytic PME pass; the rest of the
        energy is differentiated by autograd."""
        plan = self.plan
        beta = self.beta
        bp = self._bonded
        rw = float(recip_weight)
        scee, scnb, pm = self._p14_scee, self._p14_scnb, self._p14_mask
        sqrt_kc = np.float32(np.sqrt(COULOMB_CONST))

        def e_rest_fn(xv, st, props, q_plain, e_recip):
            box = st.box
            couple = st.couple
            q_kc, sh, se, cm = (props[:, 0], props[:, 1], props[:, 2],
                                props[:, 3])
            eb = bond_energy(xv, box, st.bond_idx, bp["bond_k"],
                             bp["bond_r0"])
            ea = angle_energy(xv, box, st.angle_idx, bp["angle_k"],
                              bp["angle_theta0"])
            ed = dihedral_energy(xv, box, st.dihedral_idx, bp["dihedral_k"],
                                 bp["dihedral_n"], bp["dihedral_phase"])
            e_bonded = eb + ea + ed
            # subtract the kernel's contribution for excluded and 1-4 pairs
            # (identical arithmetic => cancellation to roundoff)
            el_x, ec_x = pairlist_colpair_energy(
                xv, box, st.excl_idx, self._excl_mask, q_kc, sh, se, cm,
                couple, plan)
            el_4, ec_4 = pairlist_colpair_energy(
                xv, box, st.p14_idx, pm, q_kc, sh, se, cm, couple, plan)
            # add scaled 1-4: LJ/scnb + plain Coulomb/scee
            i = st.p14_idx[:, 0]
            j = st.p14_idx[:, 1]
            d = minimum_image(xv[i] - xv[j], box)
            r2 = torch.clamp_min(torch.sum(d * d, -1), R2_MIN)
            inv_r = torch.rsqrt(r2)
            sig = sh[i] + sh[j]
            cpl14 = 1.0 - (cm[i] + cm[j] - 2.0 * cm[i] * cm[j]) \
                * (1.0 - couple)
            s6 = (sig * sig / r2) ** 3
            e14_lj = torch.sum(pm * scnb * cpl14 * (se[i] * se[j])
                               * (s6 * s6 - s6))
            e14_c = torch.sum(pm * scee * cpl14 * q_kc[i] * q_kc[j] * inv_r)
            # self energy and the erf part of excluded pairs (they are in
            # the reciprocal sum but must not interact)
            q_eff = q_plain * (1.0 - cm * (1.0 - couple))
            e_self = -beta / math.sqrt(math.pi) * COULOMB_CONST \
                * torch.sum(q_eff * q_eff)
            ee_i = st.excl_idx[:, 0]
            ee_j = st.excl_idx[:, 1]
            dd = minimum_image(xv[ee_i] - xv[ee_j], box)
            rr = torch.sqrt(torch.clamp_min(torch.sum(dd * dd, -1), 1e-4))
            cpl_x = (1.0 - cm[ee_i] * (1.0 - couple)) \
                * (1.0 - cm[ee_j] * (1.0 - couple))
            e_corr = -COULOMB_CONST * torch.sum(
                self._excl_mask * cpl_x * q_plain[ee_i] * q_plain[ee_j]
                * torch.erf(beta * rr) / rr)
            # intra-water erf compensation by rolls: the recip sum holds
            # each water's internal pairs, the kernel masks them
            if self._wq:
                m_o = (st.w_role == 0) & (props[:, 4] > 0)
                xs = [xv] + [torch.roll(xv, -k, 0)
                             for k in range(1, self._wstride)]
                for a in range(self._wstride):
                    for b in range(a + 1, self._wstride):
                        qq = self._wq[a] * self._wq[b]
                        if abs(qq) < 1e-12:
                            continue
                        dd = minimum_image(xs[b] - xs[a], box)
                        rr_w = torch.sqrt(torch.clamp_min(
                            torch.sum(dd * dd, -1), 1e-4))
                        val = torch.erf(beta * rr_w) / rr_w
                        e_corr = e_corr - COULOMB_CONST * qq * torch.sum(
                            torch.where(m_o, val, torch.zeros_like(val)))
            # 1-4 pairs likewise: their PME direct + recip contribution
            # must reduce to scaled plain Coulomb
            r24 = torch.clamp_min(torch.sum(d * d, -1), 1e-4)
            rr4 = torch.sqrt(r24)
            cpl_x4 = (1.0 - cm[i] * (1.0 - couple)) \
                * (1.0 - cm[j] * (1.0 - couple))
            e_corr4 = -COULOMB_CONST * torch.sum(
                pm * cpl_x4 * q_plain[i] * q_plain[j]
                * torch.erf(beta * rr4) / rr4)
            e_rest = (e_bonded - el_x - ec_x - el_4 - ec_4 + e14_lj + e14_c
                      + e_recip + e_self + e_corr + e_corr4)
            if self._has_alch:
                # couple-intramol=no: the recip sum scaled the coupled
                # molecule's non-excluded internal pairs by couple^2; the
                # direct sum keeps them at full strength, so restore them
                mi, mj = st.intra_idx[:, 0], st.intra_idx[:, 1]
                ddm = minimum_image(xv[mi] - xv[mj], box)
                rrm = torch.sqrt(torch.clamp_min(torch.sum(ddm * ddm, -1),
                                                 1e-4))
                e_comp = COULOMB_CONST * (1.0 - couple * couple) * torch.sum(
                    self._im_mask * q_plain[mi] * q_plain[mj]
                    * torch.erf(beta * rrm) / rrm)
                e_rest = e_rest + e_comp
            terms = dict(bond=eb, angle=ea, dihedral=ed, recip=e_recip,
                         energy_potential_bonded=e_bonded)
            if self._has_alch:
                terms["comp"] = e_comp
            return e_rest, terms

        def force(x, st: FastState):
            self.force_evals += 1
            box = st.box
            couple = st.couple
            props = st.props
            x_v = self._apply_vsites(x, st.vm_of, box)
            f_dir, e_lj, e_c = self._direct_force(x_v, st, want_energy)
            cm = props[:, 3]
            q_plain = props[:, 0] / sqrt_kc
            if rw != 0.0:
                q_eff_o = q_plain * (1.0 - cm * (1.0 - couple))
                e_recip, g_recip = self._recip.value_and_grad(
                    x_v, q_eff_o, box)
            else:
                e_recip = torch.zeros((), dtype=x.dtype, device=x.device)
                g_recip = None
            with torch.enable_grad():
                xr = x_v.detach().requires_grad_(True)
                e_rest, terms = e_rest_fn(xr, st, props, q_plain, e_recip)
                (g,) = torch.autograd.grad(e_rest, xr)
            e_rest = e_rest.detach()
            terms = {k: v.detach() for k, v in terms.items()}
            f = f_dir - g
            if g_recip is not None:
                f = f - (g_recip if rw == 1.0 else rw * g_recip)
            f = self._spread_vsite_forces(f, st.vm_of)
            f = f * (props[:, 4:5] > 0)      # col 4 is group id, not 0/1
            e_tot = e_rest + e_lj + e_c
            terms.update(lj=e_lj, coulomb=e_c, energy_potential=e_tot,
                         energy_potential_nonbonded=e_tot
                         - terms["energy_potential_bonded"])
            return f, (e_tot, terms)

        return force

    # ------------------------------------------------------------------
    def _make_cp_cv(self):
        """(constrain_positions(x_new, x_ref, st), constrain_velocities(v,
        x, st)): rolled SETTLE for the waters, star M-SHAKE with the
        closed-form 3x3 solve for the X-H clusters."""
        ra, rb, rcs = self._settle_geom
        use_settle = self.n_waters > 0
        use_h = self._use_hshake
        if not (use_settle or use_h):
            return None, None
        hc_mask = self._hc_mask
        hc_r0 = self._hc_r0
        hc_invm = self._hc_invm
        inv_mh = hc_invm[:, 0:1]
        inv_mk = hc_invm[:, 1:]
        eye3 = torch.eye(3, dtype=torch.float32, device=self.device)[None]
        ckl = inv_mh[:, :, None] + eye3 * inv_mk[:, :, None]
        m2 = hc_mask[:, :, None] * hc_mask[:, None, :]
        a_pad = eye3 * (1.0 - hc_mask)[:, None, :] * eye3
        S = self.S

        def mask_A(A):
            """Deactivate padded constraints: identity rows/cols."""
            return A * m2 + a_pad

        def merge_rows(x, res, st):
            """Each slot pulls its row of the per-cluster result stack
            [C, 4, 3] through the ownership tables."""
            n_rows = res.shape[0]
            flat = torch.cat([res.reshape(-1, 3), torch.zeros_like(x[:1])])
            gid = torch.clamp_max(
                st.hc_of * 4 + torch.clamp(st.hc_role, 0, 3), n_rows * 4)
            return torch.where((st.hc_of < n_rows)[:, None], flat[gid], x)

        def h_index(st):
            hc = torch.clamp_max(st.hc_idx, S - 1)
            return hc[:, 0], hc[:, 1:]

        def hshake_pos(x_new, x_ref, st, iters=6):
            box = st.box
            heavy, hs = h_index(st)
            r0 = minimum_image(x_ref[hs] - x_ref[heavy][:, None, :], box)
            xk_abs = x_new[hs]                                   # [C,3,3]
            xh = x_new[heavy]                                    # [C,3]
            r = minimum_image(xk_abs - xh[:, None, :], box)
            for _ in range(iters):
                A = mask_A(2.0 * ckl * torch.einsum("cki,cli->ckl", r, r0))
                b = hc_r0 ** 2 - torch.sum(r * r, -1)
                lam = _solve3(A, b * hc_mask) * hc_mask
                dh = lam[..., None] * r0 * inv_mk[..., None]
                dheavy = -torch.sum(lam[..., None] * r0, dim=1) * inv_mh
                r = r + dh - dheavy[:, None, :]
                xh = xh + dheavy
            # re-express the Hs in their own stored image
            xk_f = xk_abs + minimum_image(xh[:, None, :] + r - xk_abs, box)
            return merge_rows(x_new, torch.cat([xh[:, None, :], xk_f], 1),
                              st)

        def hshake_vel(v, x, st):
            heavy, hs = h_index(st)
            r = minimum_image(x[hs] - x[heavy][:, None, :], st.box)
            vh = v[heavy]
            vk = v[hs]
            A = mask_A(ckl * torch.einsum("cki,cli->ckl", r, r))
            b = -torch.sum(r * (vk - vh[:, None, :]), -1)
            mu = _solve3(A, b * hc_mask) * hc_mask
            dvh = mu[..., None] * r * inv_mk[..., None]
            dvheavy = -torch.sum(mu[..., None] * r, dim=1) * inv_mh
            return merge_rows(v, torch.cat([(vh + dvheavy)[:, None, :],
                                            vk + dvh], 1), st)

        def o_mask(st):
            return (st.w_role == 0) & (st.props[:, 4] > 0)

        def cp(x_new, x_ref, st):
            if use_settle:
                x_new = settle_compute_rolled(x_new, x_ref, o_mask(st), ra,
                                              rb, rcs, 15.999, 1.008,
                                              box=st.box)
            if use_h:
                x_new = hshake_pos(x_new, x_ref, st)
            return x_new

        def cv(v, x, st):
            if use_settle:
                v = settle_velocities_rolled(v, x, o_mask(st), 15.999, 1.008,
                                             box=st.box)
            if use_h:
                v = hshake_vel(v, x, st)
            return v

        return cp, cv

    # ------------------------------------------------------------------
    def _period(self, st: FastState, dt: float, k_steps: int,
                record_energy: bool, force_cap):
        """Rebuild, then k_steps steps. Returns (state, terms, energies)."""
        cfg = self.cfg
        st = self._rebuild(st)
        cp, cv = self._make_cp_cv()
        # impulse MTS (r-RESPA) on the reciprocal force: hot periods step in
        # pairs; step A applies the carried force (with the 2x recip
        # impulse) and evaluates direct-only, step B evaluates direct + 2x
        # recip. Energy-recording periods keep per-step recip.
        mts = not record_energy and k_steps % 2 == 0
        if mts:
            forces = [self._make_force_fn(False, 0.0),
                      self._make_force_fn(False, 2.0)]
        else:
            forces = [self._make_force_fn(record_energy)]

        def make_one(force):
            return make_integrator_step(
                lambda x: force(x, st), st.masses, st.dof,
                cfg.integrator.kind, dt=dt, temp_target=cfg.temp_target,
                thermostat_tau=cfg.integrator.thermostat_tau,
                gamma=cfg.integrator.gamma,
                constrain_positions=((lambda xn, xr: cp(xn, xr, st))
                                     if cp else None),
                constrain_velocities=((lambda v, x: cv(v, x, st))
                                      if cv else None),
                force_cap=force_cap, cadence=cfg.integrator.cadence)

        steps = [make_one(fn) for fn in forces]
        # the whole period's thermostat noise in one draw
        noise = None
        if cfg.integrator.kind == "langevin_middle":
            noise = torch.randn((k_steps,) + tuple(st.v.shape),
                                generator=self.generator,
                                dtype=st.v.dtype, device=st.v.device)
        x, v, f = st.x, st.v, st.f
        es = []
        terms = {}
        for s in range(k_steps):
            x, v, f, e, terms = steps[s % len(steps)](
                x, v, f, None if noise is None else noise[s])
            es.append(e)
        if cfg.zero_com_drift:
            v = remove_com_drift(v, st.masses, st.dof)
        st = st.replace(x=x, v=v, f=f, step=st.step + k_steps,
                        pe_last=es[-1],
                        ke_last=kinetic_energy(v, st.masses, st.dof))
        return st, terms, es

    # ------------------------------------------------------------------
    def _minimize_chunk(self, st: FastState, k: int, max_disp: float):
        """Rebuild, k capped moves, then the closing force evaluation that
        keeps the carried-force invariant. Returns (state, energy of the
        last move's start)."""
        st = self._rebuild(st)
        cp, _ = self._make_cp_cv()
        force = self._make_force_fn(True)
        movable = st.dof[:, None] > 0
        x = st.x
        e = None
        for _ in range(k):
            f, (e, _t) = force(x, st)
            norm = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
            step_v = f * (max_disp / torch.clamp_min(norm, 1e-9))
            step_v = torch.where(norm > 1e-9, step_v,
                                 torch.zeros_like(step_v))
            x_new = x + step_v * movable
            if cp is not None:
                x_new = cp(x_new, x, st)
            x = x_new
        f, (e_end, _t) = force(x, st)
        return st.replace(x=x, f=f, pe_last=e_end), e

    def minimize(self, n_iters: int = 400, max_disp: float = 0.02) -> float:
        """Clash relaxation: capped-displacement steepest descent (each
        movable site moves max_disp A along its force) with the constraint
        projection after every move, neighbor_rebuild_every moves per
        rebuild, n_iters rounded up to whole rebuild periods. A table
        overflow restores the start state, replans (widening per-slice
        window tables only when they overflowed; a range-table overflow
        raises) and redoes the quench, up to 5 attempts; an energy from
        truncated tables is never returned.
        Returns the potential energy before the last move."""
        k = self.cfg.neighbor_rebuild_every
        snap = self.state
        for attempt in range(5):
            done = 0
            e = None
            with torch.no_grad():
                while done < n_iters:
                    self.state, e = self._minimize_chunk(self.state, k,
                                                         max_disp)
                    done += k
            ovf = int(self.state.overflow)
            if ovf == 0:
                break
            window = bool(ovf >> 15)
            if attempt == 4 or (window and not self._psk):
                raise ColpairOverflowError(
                    f"minimize(): overflow (col={ovf & 0x7FFF}, "
                    f"win={ovf >> 15}) persists after the replan budget "
                    f"or overflows range tables")
            self.state = snap.replace(
                overflow=torch.zeros_like(snap.overflow))
            self._replan(per_slice_k=2 * self._psk if window else None)
            snap = self.state
        return float(e)

    # ------------------------------------------------------------------
    def _replan(self, per_slice_k=None):
        """Rebuild the engine around the current state: a fresh column plan
        at the current box (NPT drift), optionally wider window tables.
        Positions, velocities, step, couple, the random stream, the table
        kind and the snapshots carry over."""
        x = self.positions_unsorted()
        v = self.velocities_unsorted()
        box = _np(self.state.box).astype(np.float64)
        keep = dict(_sim_time_ps=self._sim_time_ps,
                    _wall_time=self._wall_time, snapshots=self.snapshots,
                    pressure_log=self.pressure_log)
        evals = self.force_evals
        carry = dict(step=self.state.step, couple=self.state.couple)
        psk = self._psk if per_slice_k is None else per_slice_k
        new = FastSim(self.top, self.cfg, x, box_extent=box, velocities=v,
                      per_slice_k=psk, device=self.device,
                      generator=self.generator, triangular=self._tri)
        self.__dict__.clear()
        self.__dict__.update(new.__dict__)
        self.__dict__.update(keep)
        self.force_evals += evals      # plus the new engine's init one
        self.state = self.state.replace(**carry)

    def step(self, dt_ps: float, n_steps: int = 1, record_energy=False,
             force_cap=None):
        """One MD run request. Recovers from table overflow at period
        granularity: restore the last good state, widen per-slice window
        tables only if they overflowed, replan, resume; and from NPT box
        drift past 3% of the planned box: keep the steps done, replan at
        the current box, continue the remainder. Simulated time is
        credited only for completed steps; an exhausted retry budget, or a
        window overflow of range tables, raises (the state restored).
        Returns the per-step energies when `record_energy`."""
        energies = []
        completed = 0
        try:
            with torch.no_grad():
                for attempt in range(8):
                    if completed >= n_steps:
                        break
                    try:
                        self._step_attempt(dt_ps, n_steps - completed,
                                           record_energy, force_cap,
                                           energies)
                        completed = n_steps
                    except ColpairOverflowError as ov:
                        self.state = ov.good_state.replace(
                            overflow=torch.zeros_like(ov.good_state.overflow))
                        completed += ov.steps_good
                        del energies[ov.elen_good:]
                        if attempt >= 5 or (ov.window and not self._psk):
                            raise
                        self._replan(per_slice_k=2 * self._psk
                                     if ov.window else None)
                    except _BoxDriftReplan as bd:
                        completed += bd.steps_done
                        self._replan()
            if completed < n_steps:
                raise ColpairOverflowError(
                    f"step(): replan retry budget exhausted with only "
                    f"{completed}/{n_steps} steps completed")
        finally:
            self._sim_time_ps += dt_ps * completed
        return torch.stack(energies) if energies else None

    def _step_attempt(self, dt_ps, n_steps, record_energy, force_cap,
                      energies):
        """Period loop of one attempt; the overflow flag is checked after
        every period, and the raised error carries the last good state.
        With a barostat, a period whose tables held is followed by the
        Berendsen scaling and then the drift check, which raises
        _BoxDriftReplan past 3% of the planned box."""
        t0 = time.perf_counter()
        k = self.cfg.neighbor_rebuild_every
        done = 0
        try:
            while done < n_steps:
                todo = min(k, n_steps - done)
                good = (self.state, done, len(energies))
                st, terms, es = self._period(self.state, float(dt_ps), todo,
                                             record_energy, force_cap)
                ovf = int(st.overflow)
                if ovf:
                    raise ColpairOverflowError(
                        f"colpair overflow (col={ovf & 0x7FFF}, "
                        f"win={ovf >> 15}): replan required",
                        good_state=good[0], steps_good=good[1],
                        elen_good=good[2], window=bool(ovf >> 15))
                self.state = st
                self._last_terms = terms
                if record_energy:
                    energies.extend(es)
                done += todo
                if self.cfg.barostat_cfg is not None:
                    self.state, self._last_pressure = self._barostat(
                        self.state, float(dt_ps) * todo)
                    box_x = float(self.state.box[0])
                    self.pressure_log.append((self.state.step,
                                              float(self._last_pressure),
                                              box_x))
                    # the columns and windows were planned for _box0: a few
                    # percent of isotropic drift stays inside the skin
                    ratio = box_x / self._box0[0]
                    if abs(ratio - 1.0) > 0.03:
                        raise _BoxDriftReplan(done)
        finally:
            self._wall_time += time.perf_counter() - t0
        if n_steps > 0 and not (torch.isfinite(self.state.pe_last)
                                & torch.isfinite(self.state.ke_last)):
            raise NonFiniteEnergyError("non-finite energy after a step call")

    # ------------------------------------------------------------------
    def _barostat(self, st: FastState, dt_eff: float):
        """Period-boundary Berendsen NPT: the molecular (COM-scaling)
        virial pressure by a central difference of the energy force
        function (two force evaluations), then each molecule translated by
        (mu - 1) COM and the box scaled by mu. Returns (state, p_bar)."""
        from .barostat import _mol_com, berendsen_mu, scaling_pressure_bar_fd

        baro = self.cfg.barostat_cfg
        force_e = self._make_force_fn(True)
        n_mol = self._n_mol + 1
        mol_of = self._mol_b[torch.clamp(st.perm, 0, self.n_base)]

        def e_scalar(x_, b_, _c):
            return force_e(x_, st.replace(box=b_))[1][0]

        p = scaling_pressure_bar_fd(e_scalar, st.x, st.box, st.v, st.masses,
                                    st.dof, st.couple, mol_of, n_mol)
        mu = berendsen_mu(p, baro.pressure_target, baro.tau,
                          dt_eff).to(st.x.dtype)
        com, _ = _mol_com(st.x, st.masses, st.dof, mol_of, n_mol)
        return st.replace(x=st.x + (mu - 1.0) * com[mol_of],
                          box=st.box * mu), p

    def run(self, dt_ps: float, n_steps: int,
            snapshot_interval: Optional[int] = None, collect=True):
        """Step n_steps in calls of snapshot_interval steps (default the
        config's in-memory snapshot interval, else one call), recording a
        Snapshot after each call when `collect`. With cfg.trace_dir set,
        the whole run is traced by torch.profiler and its Chrome trace is
        written there. Returns the snapshot list."""
        if snapshot_interval is None:
            snapshot_interval = self.cfg.snapshot_handlers.memory or n_steps
        prof = contextlib.nullcontext()
        if self.cfg.trace_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [])
            prof = profile(activities=acts)
        done = 0
        with prof:
            while done < n_steps:
                todo = min(snapshot_interval, n_steps - done)
                self.step(dt_ps, todo)
                done += todo
                if collect:
                    self._record_snapshot(dt_ps)
        if self.cfg.trace_dir:
            os.makedirs(self.cfg.trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                self.cfg.trace_dir, f"fastsim_run_{self.step_count}.json"))
        return self.snapshots

    def _record_snapshot(self, dt_ps):
        """Append a Snapshot of the current state: base-order positions and
        the energy decomposition, one evaluation of the energy force
        function (hot periods run the force-only kernels)."""
        from .snapshot import EnergyData, Snapshot

        x = self.positions_unsorted()
        with torch.no_grad():
            _, (_, terms) = self._make_force_fn(True)(self.state.x,
                                                      self.state)
        self._last_terms = terms
        self.snapshots.append(Snapshot(
            time=float(self.step_count) * dt_ps, atom_posits=x,
            energy_data=EnergyData(
                energy_potential=float(terms["energy_potential"]),
                energy_potential_nonbonded=float(
                    terms["energy_potential_nonbonded"]),
                energy_potential_bonded=float(
                    terms["energy_potential_bonded"]))))

    def computation_time(self) -> float:
        """Wall seconds spent inside step calls."""
        return self._wall_time

    # ------------------------------------------------------------------
    def metrics(self) -> dict:
        wall = max(self._wall_time, 1e-12)
        return {
            "steps": int(self.step_count),
            "wall_s": round(wall, 4),
            "sim_ps": round(self._sim_time_ps, 4),
            "ms_per_step": round(1000.0 * wall / max(self.step_count, 1), 4),
            "ns_per_day": round(self._sim_time_ps / 1000.0 / wall * 86400.0,
                                3),
            "n_sites": int(self.top.n_atoms_real),
        }

    def positions_unsorted(self) -> np.ndarray:
        """Positions in base order [n_base, 3], vsites refreshed."""
        st = self.state
        x = self._apply_vsites(st.x, st.vm_of, st.box)
        out = torch.zeros((self.n_base + 1, 3), dtype=x.dtype,
                          device=x.device)
        out[st.perm] = x
        return _np(out[:self.n_base])

    def velocities_unsorted(self) -> np.ndarray:
        st = self.state
        out = torch.zeros((self.n_base + 1, 3), dtype=st.v.dtype,
                          device=st.v.device)
        out[st.perm] = st.v
        return _np(out[:self.n_base])

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    def temperature(self) -> float:
        st = self.state
        v = _np(st.v).astype(np.float64)
        m = _np(st.masses).astype(np.float64)
        d = _np(st.dof).astype(np.float64)
        ke = 0.5 * float((m * d * (v * v).sum(-1)).sum()) / ACCEL_FACTOR
        ndof = max(3.0 * d.sum() - self.n_constraints - 3.0, 1.0)
        return 2.0 * ke / (KB * ndof)

    def potential_energy(self) -> float:
        with torch.no_grad():
            e, terms = self._make_force_fn(True)(self.state.x,
                                                 self.state)[1]
        self._last_terms = terms
        return float(e)

    def configure_alchemical_window(self, lam: float):
        """Reference convention: lambda 0 = fully coupled (couple = 1)."""
        self.state = self.state.replace(couple=torch.tensor(
            1.0 - lam, dtype=torch.float32, device=self.device))

    def dhdl(self) -> float:
        """dH/dlambda at the current state: the central difference
        -(E(couple + h) - E(couple - h)) / 2h in float32, h = 1e-3, through
        the energy force function (two force evaluations). 0.0 when nothing
        is coupled. Its float32 floor is about eps32 * sum|terms| / 2h."""
        if not self._has_alch:
            return 0.0
        st = self.state
        force = self._make_force_fn(True)
        h = torch.tensor(1e-3, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            ep = force(st.x, st.replace(couple=st.couple + h))[1][0]
            em = force(st.x, st.replace(couple=st.couple - h))[1][0]
        return float(-(ep - em) / (2.0 * h))
