"""MdSim: the general MD engine on its cell-grid path (port of
molchanica_tpu.md.engine for method "cells_pme" with cfg.use_pallas).

One call of `step(dt, n)` is a Python loop over exactly n steps:

  every k = neighbor_rebuild_every steps from the start of the call:
      rebuild the cell binning (M sites placed first) and fix each atom's
      whole-box image, then one fresh force
  each step: one integrator step, one force (vsites -> cell-grid kernel
      -> PME + bonded + exclusion subtraction by autograd)
  after the loop: COM-drift removal, the final force, kinetic energy and
      dH/dlambda

so a call makes n + ceil(n/k) + 1 kernel launches. The reference's
default scan-chunk path instead rounds n down to a multiple of k; the two
agree whenever n is a multiple of k. Two more differences, both faults of
the reference (ROADMAP Queue 3): it bins the M sites at their positions of
the call's start (it refreshes them only at the finalize), and it wraps
positions into the box at every force, so an atom that crosses a box face
between rebuilds loses its kernel pairs. The port bins placed M sites and
keeps the images of the rebuild until the next one (see
ops/direct_force.py::DirectForce); where no atom crossed, the two give the
same numbers. An overflowing rebuild raises
CellOverflowError; `step` restores the state of the call's start, replans
from it and retries, up to 3 attempts.

The other direct-space backends (clusters, window, allpairs), FIRE
relaxation, the barostat, coupled atoms, `run` and snapshots are not
ported: MdSim raises NotImplementedError for them and never falls back.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import ACCEL_FACTOR, KB
from ..device import resolve_device
from ..ops.direct_force import (DirectForce, image_shift, make_rebuild_fn,
                                plan_window)
from ..ops.pme import ewald_beta_for, make_pme_recip_fn
from .config import MdConfig
from .constraints import make_constraint_fns
from .energy import apply_virtual_sites, make_energy_fn, make_force_fn
from .integrators import make_integrator_step
from .state import MdState, init_velocities, kinetic_energy, remove_com_drift


def select_method(box_extent, n_atoms, cfg: MdConfig) -> str:
    if box_extent is None:
        return "allpairs"
    if n_atoms <= 2048:
        return "allpairs_cutoff"
    return "cells_pme"


class CellOverflowError(RuntimeError):
    """A rebuild put more atoms into a cell than its capacity."""


def _np(t):
    return t.detach().cpu().numpy()


class MdSim:
    """One simulation: topology and config fixed, MdState dynamic, on
    `device` (None means the CUDA card)."""

    def __init__(self, top, cfg: MdConfig, x0, box_extent=None,
                 velocities=None,
                 external_forces_fn: Optional[Callable] = None,
                 method: Optional[str] = None, relax: Optional[bool] = None,
                 device=None):
        dev = resolve_device(device)
        self.device = dev
        kind = cfg.integrator.kind
        if kind not in ("leapfrog", "verlet_velocity", "langevin_middle"):
            raise ValueError(
                f"unknown integrator kind: {kind!r} "
                "(expected leapfrog | verlet_velocity | langevin_middle)")
        if kind == "leapfrog" or (kind == "verlet_velocity"
                                  and cfg.integrator.thermostat_tau
                                  is not None):
            raise NotImplementedError(
                "leapfrog and the CSVR thermostat are not ported (ROADMAP "
                "Queue 1 item 6)")
        x0_np = np.asarray(x0, np.float32)
        n = x0_np.shape[0]
        assert n == top.n_atoms, (n, top.n_atoms)
        self.method = method or select_method(box_extent, n, cfg)
        if self.method != "cells_pme" or not cfg.use_pallas:
            raise NotImplementedError(
                f"MdSim method {self.method!r} with use_pallas="
                f"{cfg.use_pallas}: only cells_pme with the cell-grid kernel "
                "is ported (ROADMAP Queue 1 item 7: the clusters, window and "
                "allpairs backends)")
        if cfg.dtype != "float32":
            raise NotImplementedError(
                "the cell-grid path is float32 only (ROADMAP Queue 1 item 7)")
        if relax is None:
            relax = cfg.max_init_relaxation_iters is not None
        if relax and cfg.max_init_relaxation_iters:
            raise NotImplementedError(
                "FIRE relaxation (md/minimize.py) is not ported (ROADMAP "
                "Queue 1 item 7); pass relax=False")
        if cfg.barostat_cfg is not None:
            raise NotImplementedError(
                "the MdSim barostat is not ported (ROADMAP Queue 1 item 7)")
        if float(top.couple_mask.sum()) > 0:
            raise NotImplementedError(
                "coupled atoms need intramol_recip_compensation and the "
                "finite-difference dhdl (ROADMAP Queue 1 item 7)")
        if dev.type == "cuda":
            # PME's products are float32 matmuls: keep them in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.top = top.to(dev)
        self.cfg = cfg
        self._box_np = np.asarray(box_extent, np.float32)
        box = torch.as_tensor(self._box_np, device=dev)
        self._cp, self._cv, self.n_constraints = make_constraint_fns(
            self.top, cfg, box)
        self.force_evals = 0       # force evaluations = kernel launches
        self._build_force_paths(x0_np)
        self._external_forces_fn = external_forces_fn

        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        if velocities is None:
            v = init_velocities(gen, self.top.masses, self.top.dof_mask,
                                cfg.temp_target)
        else:
            v = torch.as_tensor(np.asarray(velocities, np.float32),
                                device=dev)
        x = torch.as_tensor(x0_np, device=dev)
        if self._cp is not None:
            with torch.no_grad():
                x = self._cp(x, x)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.state = MdState(
            positions=x, velocities=v, box=box, step=0, generator=gen,
            couple=torch.ones((), dtype=torch.float32, device=dev),
            pe_last=zero, ke_last=zero, dhdl_last=zero)
        self._wall_time = 0.0
        self._sim_time_ps = 0.0
        self._last_terms = None

    # ------------------------------------------------------------------
    def rebuild_neighbor_plan(self):
        """Re-plan the cell geometry and capacity from the current
        positions and rebuild the force paths."""
        self._build_force_paths(_np(self.state.positions))

    def _build_force_paths(self, x0_np):
        top, cfg = self.top, self.cfg
        cutoff = max(cfg.lj_cutoff, cfg.coulomb_cutoff)
        self._recip = make_pme_recip_fn(top, cfg, self._box_np,
                                        device=self.device)
        plan = plan_window(self._box_np, cutoff, top.n_atoms_real,
                           top.n_atoms, x0=x0_np)
        self._plan = plan
        self._rebuild = make_rebuild_fn(plan, top.atom_mask)
        self._direct = direct = DirectForce(top, plan)
        # on the device once per plan: K2's launch then copies nothing from
        # the host (CUDA-graph capture)
        self._beta = beta = torch.tensor(
            ewald_beta_for(cfg.coulomb_cutoff, cfg.ewald_rtol),
            dtype=torch.float32, device=self.device)
        rest_fg = make_force_fn(make_energy_fn(top, cfg, "pme_rest",
                                               pme_recip_fn=self._recip))
        vs = top.vsite_idx
        vs_m, vs_o, vs_h1, vs_h2 = vs[:, 0], vs[:, 1], vs[:, 2], vs[:, 3]
        vs_w = top.vsite_weight[:, None]
        vs_mask = top.vsite_mask[:, None]
        has_vsites = float(top.vsite_mask.sum()) > 0

        def spread_vsite_forces(f):
            """M = (1-2w) O + w H1 + w H2 is linear: spread the kernel's
            M-site forces onto the parents exactly. Padded rows repeat
            index 0 with a zero force, so every scatter adds."""
            if not has_vsites:
                return f
            fm = f[vs_m] * vs_mask
            f = f.index_add(0, vs_m, -fm)
            f = f.index_add(0, vs_o, (1.0 - 2.0 * vs_w) * fm)
            f = f.index_add(0, vs_h1, vs_w * fm)
            return f.index_add(0, vs_h2, vs_w * fm)

        @torch.no_grad()
        def force_nbr(x, box, couple, slot_atom, inv_slot, shift=None):
            self.force_evals += 1
            x = apply_virtual_sites(x, top)       # M tracks O/H1/H2
            f1, e_lj, e_c, ovf_d = direct(x, box, couple, beta, slot_atom,
                                          inv_slot, shift)
            f1 = spread_vsite_forces(f1)
            f2, (e_rest, terms) = rest_fg(x, box, couple)
            e_tot = e_rest + e_lj + e_c
            terms = dict(terms)
            terms["lj"] = terms["lj"] + e_lj
            terms["coulomb"] = terms["coulomb"] + e_c
            terms["energy_potential"] = e_tot
            terms["energy_potential_nonbonded"] = (
                terms["energy_potential_nonbonded"] + e_lj + e_c)
            terms["cell_overflow"] = terms["cell_overflow"] + ovf_d
            return f1 + f2, (e_tot, terms)

        self._force_nbr = force_nbr
        rebuild = self._rebuild

        @torch.no_grad()
        def force_fn(x, box, couple):
            sa, inv, _ = rebuild(apply_virtual_sites(x, top), box)
            return force_nbr(x, box, couple, sa, inv)

        self.force_fn = force_fn
        self.energy_fn = lambda x, box, couple: force_fn(x, box, couple)[1]
        # no coupled atoms on this path (the constructor refuses them)
        self.dhdl_fn = lambda x, box, couple: torch.zeros(
            (), dtype=x.dtype, device=x.device)

    # ------------------------------------------------------------------
    def configure_alchemical_window(self, lam: float):
        """Reference convention: lambda 0 = fully coupled."""
        self.state = self.state.replace(couple=torch.tensor(
            1.0 - lam, dtype=torch.float32, device=self.device))

    def computation_time(self) -> float:
        return self._wall_time

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    @property
    def external_forces_fn(self):
        return self._external_forces_fn

    # ------------------------------------------------------------------
    def _make_one_step(self, dt, force, force_cap):
        ic = self.cfg.integrator
        return make_integrator_step(
            force, self.top.masses, self.top.dof_mask, ic.kind, dt=dt,
            temp_target=self.cfg.temp_target,
            thermostat_tau=ic.thermostat_tau, gamma=ic.gamma,
            constrain_positions=self._cp, constrain_velocities=self._cv,
            force_cap=force_cap, cadence=ic.cadence)

    def _step_hostloop(self, dt, n_steps, record_energy, force_cap):
        s = self.state
        x, v, box, couple = s.positions, s.velocities, s.box, s.couple
        ext = self._external_forces_fn
        k = self.cfg.neighbor_rebuild_every
        langevin = self.cfg.integrator.kind == "langevin_middle"
        force_nbr = self._force_nbr
        energies, ovf_all = [], []
        one = f = None
        for i in range(n_steps):
            if i % k == 0:
                xv = apply_virtual_sites(x, self.top)
                sa, inv, ovf = self._rebuild(xv, box)
                ovf_all.append(ovf)
                shift = image_shift(xv, box)

                def force(x_, sa=sa, inv=inv, shift=shift):
                    f_, rest = force_nbr(x_, box, couple, sa, inv, shift)
                    if ext is not None:
                        f_ = f_ + ext(x_)
                    return f_, rest

                f = force(x)[0]
                one = self._make_one_step(dt, force, force_cap)
            noise = (torch.randn(x.shape, generator=s.generator,
                                 dtype=x.dtype, device=x.device)
                     if langevin else None)
            x, v, f, e, _ = one(x, v, f, noise)
            if record_energy:
                energies.append(e)
        ovf_max = int(torch.stack(ovf_all).max()) if ovf_all else 0
        if self.cfg.zero_com_drift:
            v = remove_com_drift(v, self.top.masses, self.top.dof_mask)
        x = apply_virtual_sites(x, self.top)
        _, (e_final, terms) = self.force_fn(x, box, couple)
        ke = kinetic_energy(v, self.top.masses, self.top.dof_mask)
        self.state = s.replace(positions=x, velocities=v,
                               step=s.step + n_steps, pe_last=e_final,
                               ke_last=ke,
                               dhdl_last=self.dhdl_fn(x, box, couple))
        self._last_terms = terms
        if ovf_max > 0:
            raise CellOverflowError(
                f"cell-list overflow: {ovf_max} atoms dropped from binning")
        return torch.stack(energies) if energies else None

    def step(self, dt_ps: float, n_steps: int = 1, record_energy=False,
             force_cap=None):
        """Advance exactly n_steps of dt_ps (ps). `force_cap` clamps
        per-atom forces (kcal/mol/A). On a cell overflow the call restarts
        from its first state after a replan, up to 3 attempts."""
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                for attempt in range(3):
                    saved = self.state
                    gen_state = saved.generator.get_state()
                    try:
                        energies = self._step_hostloop(
                            float(dt_ps), n_steps, record_energy, force_cap)
                        break
                    except CellOverflowError:
                        if attempt == 2:
                            raise
                        self.state = saved
                        saved.generator.set_state(gen_state)
                        self.rebuild_neighbor_plan()
        finally:
            self._wall_time += time.perf_counter() - t0
        self._sim_time_ps += dt_ps * n_steps
        return energies

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

    def _kinetic_np(self) -> float:
        v = _np(self.state.velocities).astype(np.float64)
        m = _np(self.top.masses).astype(np.float64)
        d = _np(self.top.dof_mask).astype(np.float64)
        return 0.5 * float((m * d * (v * v).sum(-1)).sum()) / ACCEL_FACTOR

    def temperature(self) -> float:
        d = _np(self.top.dof_mask).astype(np.float64)
        ndof = max(3.0 * d.sum() - self.n_constraints - 3.0, 1.0)
        return 2.0 * self._kinetic_np() / (KB * ndof)

    def potential_energy(self) -> float:
        s = self.state
        e, terms = self.force_fn(s.positions, s.box, s.couple)[1]
        self._last_terms = terms
        return float(e)

    def total_energy(self) -> float:
        return self.potential_energy() + self._kinetic_np()

    @torch.no_grad()
    def direct_space_scales(self, x):
        """The float32 scales of the cell-grid kernel's output at positions
        x, from its plain version's stats: per atom, the sum over its pairs
        of the pair-force term magnitudes (M-site rows spread onto O/H1/H2
        as the force is); and for the "lj" and "coulomb" energy terms, the
        half sums of |e_lj| and |e_c| over all pairs. Both hold the
        excluded solute pairs that the rest energy subtracts again, which
        is where float32 leaves its largest residue."""
        from ..ops.direct_force import direct_force_plain

        s = self.state
        xv = apply_virtual_sites(x, self.top)
        sa, inv, _ = self._rebuild(xv, s.box)
        center, ghost = self._direct.inputs(xv, s.box, sa)
        stats = {}
        direct_force_plain(center, ghost, self._direct.starts, s.couple,
                           self._beta, self._direct.rc2, stats=stats)
        top = self.top
        a = (stats["f_abs"][inv] * top.atom_mask)[:, None]
        vs = top.vsite_idx
        am = a[vs[:, 0]] * top.vsite_mask[:, None]
        for col in (1, 2, 3):
            a = a.index_add(0, vs[:, col], am)
        return a[:, 0], {"lj": stats["e_abs_lj"],
                         "coulomb": stats["e_abs_c"]}
