"""MdSim: the general MD engine (port of molchanica_tpu.md.engine).

Methods (`select_method`): "allpairs" for vacuum, "allpairs_cutoff" for
boxes of up to 2,048 sites, "cells_pme" above. The direct space of
"cells_pme" has three backends:

  pallas    the cell-grid kernel K2 (ops/direct_force.py, csrc/
            direct_force.cu) when cfg.use_pallas; float32 only, and a box
            too small for it raises: the port never falls back silently
  clusters  the default when the box is at least 2 rc per axis: Morton-
            sorted cluster-pair lists (ops/clusters.py)
  window    the dense shift window (ops/cells.py), for smaller boxes or
            with cfg.direct_backend == "window"

Their forces are analytic; PME, bonded and the exclusion subtraction
("pme_rest") come by autograd. The allpairs methods are autograd of their
energy throughout.

One call of `step(dt, n)` is a Python loop over exactly n steps:

  every k = neighbor_rebuild_every steps from the start of the call:
      (with a barostat, after the first block) Berendsen scaling of the
      block just run, by molecular COM scaling with the exact autograd
      virial; then the M sites placed, the neighbour rebuild (K2 cell
      binning with each atom's whole-box image fixed, or the cluster list)
      and one fresh force
  each step: one integrator step with one force evaluation
  after the loop: the last block's barostat scaling, COM-drift removal,
      the final force, kinetic energy and dH/dlambda

Differences from the reference (ROADMAP Queue 3): it splits a step call
into steps_per_chunk chunks and removes the COM drift per chunk (`run`
keeps that chunking, so it matches); it rounds a chunk down to a multiple
of k on the neighbour-list backends; it sorts and bins the M sites at
stale positions, while the port places them before every rebuild; it
applies the barostat only on its scan-chunk path, once per chunk on the
allpairs and window methods, while the port applies it per block of k
steps everywhere. Where no atom crossed a face, n is a multiple of k and
the M rows were placed, the two give the same numbers.

An overflowing rebuild (a cell past its capacity, a cluster row past M)
raises; `step` restores the state of the call's start, replans (for
clusters with the list width x 1.5) and retries, up to 3 attempts.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..constants import ACCEL_FACTOR, KB
from ..device import resolve_device
from ..ops.cells import make_cell_direct_space_fn, make_xla_direct_force_fn
from ..ops.clusters import (make_cluster_direct_force_fn,
                            make_cluster_rebuild_fn, plan_clusters)
from ..ops.direct_force import (DirectForce, image_shift, make_rebuild_fn,
                                plan_window)
from ..ops.pme import ewald_beta_for, make_pme_recip_fn
from .barostat import berendsen_scale_chunk
from .config import MdConfig
from .constraints import make_constraint_fns
from .energy import (apply_virtual_sites, make_dhdl_fn, make_energy_fn,
                     make_force_fn)
from .integrators import csvr_draws, csvr_ndof, make_integrator_step
from .minimize import fire_minimize
from .snapshot import run_in_chunks, snapshot_from_state
from .state import MdState, init_velocities, kinetic_energy, remove_com_drift


def select_method(box_extent, n_atoms, cfg: MdConfig) -> str:
    if box_extent is None:
        return "allpairs"
    if n_atoms <= 2048:
        return "allpairs_cutoff"
    return "cells_pme"


class CellOverflowError(RuntimeError):
    """A binning put more atoms into a cell than its capacity."""


class ClusterOverflowError(RuntimeError):
    """A cluster had more neighbour clusters than the list width M."""


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
        if cfg.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype {cfg.dtype!r}: float32 or float64")
        dtype = getattr(torch, cfg.dtype)
        self.dtype = dtype
        x0_np = np.array(x0, cfg.dtype)
        n = x0_np.shape[0]
        assert n == top.n_atoms, (n, top.n_atoms)
        self.method = method or select_method(box_extent, n, cfg)
        if self.method == "cells_pme" and box_extent is None:
            raise ValueError("method cells_pme needs a box")
        if self.method == "cells_pme" and cfg.use_pallas \
                and cfg.dtype != "float32":
            raise NotImplementedError(
                "the cell-grid kernel (use_pallas=True) is float32 only; "
                "use_pallas=False runs the cluster-pair backend in float64 "
                "(ROADMAP Queue 3: the port refuses the reference's silent "
                "fallback)")
        if dev.type == "cuda":
            # PME's products are float32 matmuls: keep them in full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.top = top.to(dev, dtype)
        self.cfg = cfg
        self._box_np = (None if box_extent is None
                        else np.asarray(box_extent, cfg.dtype))
        box = (None if box_extent is None
               else torch.as_tensor(self._box_np, device=dev))
        self._cp, self._cv, self.n_constraints = make_constraint_fns(
            self.top, cfg, box)
        self._ndof = csvr_ndof(self.top.dof_mask, self.n_constraints)
        self.force_evals = 0       # force evaluations (K2: kernel launches)
        self._m_scale = 1.0        # cluster-list width factor (replans)
        self._build_force_paths(x0_np)
        self._external_forces_fn = external_forces_fn

        gen = torch.Generator(device=dev)
        gen.manual_seed(cfg.seed)
        if velocities is None:
            v = init_velocities(gen, self.top.masses, self.top.dof_mask,
                                cfg.temp_target)
        else:
            v = torch.as_tensor(np.asarray(velocities, cfg.dtype),
                                device=dev)
        x = torch.as_tensor(x0_np, device=dev)
        if self._cp is not None:
            with torch.no_grad():
                x = self._cp(x, x)
        zero = torch.zeros((), dtype=dtype, device=dev)
        self.state = MdState(
            positions=x, velocities=v, box=box, step=0, generator=gen,
            couple=torch.ones((), dtype=dtype, device=dev),
            pe_last=zero, ke_last=zero, dhdl_last=zero)
        self.snapshots: list = []
        self.pressure_log: list = []   # (step, P bar, box x) per block
        self._last_pressure = None
        self._wall_time = 0.0
        self._sim_time_ps = 0.0
        self._last_terms = None
        self.relax_log = None

        if relax is None:
            relax = cfg.max_init_relaxation_iters is not None
        if relax and cfg.max_init_relaxation_iters:
            self._relax(cfg.max_init_relaxation_iters)

    # ------------------------------------------------------------------
    def _relax(self, n_iters):
        """FIRE over n_iters force evaluations from the current state and
        one more at its end, then the M sites placed and the neighbour plan
        remade from the relaxed geometry (a clash-inflated occupancy would
        otherwise hold for the whole run). The reference checks the end
        energy against E0 + max(1% |E0|, 10 kcal/mol) and, failing it,
        reruns the same FIRE on the host, which ends where it did; the port
        keeps the lowest-energy state FIRE evaluated instead (on config 3
        FIRE climbs from -64,277 to +1,362 kcal/mol: ROADMAP Queue 3).
        `relax_log` keeps the energies, the state kept and the wall
        time."""
        s = self.state
        t0 = time.perf_counter()
        energies, best = [], {}
        with torch.no_grad():
            x_min, e_last = fire_minimize(
                self.force_fn, s.positions, s.box, s.couple,
                self.top.dof_mask, n_steps=n_iters,
                constrain_positions=self._cp, energies=energies, best=best)
            e_end = float(self.force_fn(x_min, s.box, s.couple)[1][0])
            e0 = float(energies[0])
            kept = "end"
            if not e_end <= e0 + max(0.01 * abs(e0), 10.0):
                x_min, kept = best["x"], "lowest"
            self.state = s.replace(
                positions=apply_virtual_sites(x_min, self.top))
        self.rebuild_neighbor_plan()
        self.relax_log = dict(iters=n_iters, e_first=e0,
                              e_last=float(e_last), e_end=e_end,
                              e_lowest=float(best["e"]), kept=kept,
                              seconds=time.perf_counter() - t0)

    def rebuild_neighbor_plan(self):
        """Re-plan the neighbour structure from the current positions (cell
        capacity, cluster-list width) and rebuild the force paths."""
        if self.method == "cells_pme":
            self._build_force_paths(_np(self.state.positions))

    def _build_force_paths(self, x0_np):
        """Build force_fn(x, box, couple) -> (F, (E, terms)), energy_fn,
        dhdl_fn, and the neighbour-state triple the step loop drives:
        _rebuild_nbr(x, box) -> (nbr, overflow or None), _force_nbr(x, box,
        couple, nbr) and _energy_nbr(x, box, couple, nbr) -> E (the
        differentiable energy the barostat takes dE/ds of)."""
        top, cfg = self.top, self.cfg
        self._plan = None
        self._nbr_backend = None
        if self.method != "cells_pme":
            energy_fn = make_energy_fn(top, cfg, self.method)
            fg = make_force_fn(energy_fn)

            def force_fn(x, box, couple):
                self.force_evals += 1
                return fg(x, box, couple)

            self.force_fn = force_fn
            self.energy_fn = energy_fn
            self.dhdl_fn = make_dhdl_fn(energy_fn)
            self._rebuild_nbr = lambda x, box: ((), None)
            self._force_nbr = lambda x, box, couple, nbr: force_fn(
                x, box, couple)
            self._energy_nbr = lambda x, box, couple, nbr: energy_fn(
                x, box, couple)[0]
            return

        box_np = self._box_np
        cutoff = max(cfg.lj_cutoff, cfg.coulomb_cutoff)
        self._recip = make_pme_recip_fn(top, cfg, box_np, device=self.device)
        # on the device once per plan: K2's launch then copies nothing from
        # the host (CUDA-graph capture)
        self._beta = beta = torch.tensor(
            ewald_beta_for(cfg.coulomb_cutoff, cfg.ewald_rtol),
            dtype=self.dtype, device=self.device)
        rest_e = make_energy_fn(top, cfg, "pme_rest", pme_recip_fn=self._recip)
        rest_fg = make_force_fn(rest_e)

        if cfg.use_pallas:
            plan = plan_window(box_np, cutoff, top.n_atoms_real,
                               top.n_atoms, x0=x0_np)
            rebuild = make_rebuild_fn(plan, top.atom_mask)
            self._direct = kernel = DirectForce(top, plan)
            self._nbr_backend = "pallas"

            def rebuild_nbr(xv, box):
                sa, inv, ovf = rebuild(xv, box)
                return (sa, inv, image_shift(xv, box)), ovf

            def direct_nbr(x, box, couple, nbr, want_force=True):
                return kernel(x, box, couple, beta, *nbr)

            def energy_nbr(x, box, couple, nbr):
                return self._baro_energy()(x, box, couple)[0]

            self._rebuild = rebuild
        elif cfg.direct_backend != "window" \
                and (box_np >= 2.0 * cutoff).all():
            plan = plan_clusters(box_np, cutoff, top.n_atoms_real,
                                 top.n_atoms, m_scale=self._m_scale)
            rebuild = make_cluster_rebuild_fn(plan, top)
            self._direct = clus = make_cluster_direct_force_fn(top, cfg, plan)
            self._nbr_backend = "clusters"

            def rebuild_nbr(xv, box):
                order, nbr, ovf = rebuild(xv, box)
                return (order, nbr), ovf

            def direct_nbr(x, box, couple, nbr, want_force=True):
                return clus(x, box, couple, beta, *nbr,
                            want_force=want_force)

            self._rebuild = rebuild
        else:
            win = make_xla_direct_force_fn(top, cfg, box_np, x0=x0_np)
            self._direct = win
            plan = win.plan
            self._nbr_backend = "window"

            def rebuild_nbr(xv, box):
                return (), None

            def direct_nbr(x, box, couple, nbr, want_force=True):
                return win(x, box, couple, beta, want_force=want_force)

            self._rebuild = None
        self._plan = plan

        if self._nbr_backend != "pallas":
            def energy_nbr(x, box, couple, nbr):
                x = apply_virtual_sites(x, top)
                _, e_lj, e_c, _ = direct_nbr(x, box, couple, nbr,
                                             want_force=False)
                return rest_e(x, box, couple)[0] + e_lj + e_c

        vs = top.vsite_idx
        vs_m, vs_o, vs_h1, vs_h2 = vs[:, 0], vs[:, 1], vs[:, 2], vs[:, 3]
        vs_w = top.vsite_weight[:, None]
        vs_mask = top.vsite_mask[:, None]
        has_vsites = float(top.vsite_mask.sum()) > 0

        def spread_vsite_forces(f):
            """M = (1-2w) O + w H1 + w H2 is linear: spread the direct
            space's M-site forces onto the parents exactly. Padded rows
            repeat index 0 with a zero force, so every scatter adds."""
            if not has_vsites:
                return f
            fm = f[vs_m] * vs_mask
            f = f.index_add(0, vs_m, -fm)
            f = f.index_add(0, vs_o, (1.0 - 2.0 * vs_w) * fm)
            f = f.index_add(0, vs_h1, vs_w * fm)
            return f.index_add(0, vs_h2, vs_w * fm)

        @torch.no_grad()
        def force_nbr(x, box, couple, nbr):
            self.force_evals += 1
            x = apply_virtual_sites(x, top)       # M tracks O/H1/H2
            f1, e_lj, e_c, ovf_d = direct_nbr(x, box, couple, nbr)
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

        @torch.no_grad()
        def force_fn(x, box, couple):
            nbr, _ = rebuild_nbr(apply_virtual_sites(x, top), box)
            return force_nbr(x, box, couple, nbr)

        self._rebuild_nbr = rebuild_nbr
        self._force_nbr = force_nbr
        self._energy_nbr = energy_nbr
        self.force_fn = force_fn
        self.energy_fn = lambda x, box, couple: force_fn(x, box, couple)[1]
        if float(top.couple_mask.sum()) > 0:
            def dhdl_fn(x, box, couple):
                # central difference in couple through the force path;
                # d/dlambda = -d/dcouple
                h = 1e-3
                ep = force_fn(x, box, couple + h)[1][0]
                em = force_fn(x, box, couple - h)[1][0]
                return -(ep - em) / (2.0 * h)
        else:
            def dhdl_fn(x, box, couple):
                return torch.zeros((), dtype=x.dtype, device=x.device)
        self.dhdl_fn = dhdl_fn

    def _baro_energy(self):
        """The K2 path's differentiable energy for the barostat: method
        cells_pme on the cell window (ops/cells.py), planned once from the
        positions of its first use, as the reference does."""
        if getattr(self, "_baro_e_fn", None) is None:
            direct = make_cell_direct_space_fn(
                self.top, self.cfg, self._box_np,
                x0=_np(self.state.positions))
            self._baro_e_fn = make_energy_fn(
                self.top, self.cfg, "cells_pme", pme_recip_fn=self._recip,
                direct_space_fn=direct)
        return self._baro_e_fn

    # ------------------------------------------------------------------
    def configure_alchemical_window(self, lam: float):
        """Reference convention: lambda 0 = fully coupled."""
        self.state = self.state.replace(couple=torch.tensor(
            1.0 - lam, dtype=self.dtype, device=self.device))

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
            force_cap=force_cap, cadence=ic.cadence,
            n_constraints=self.n_constraints)

    def _barostat(self, x, v, box, couple, nbr, dt_eff, step):
        """Berendsen scaling at a block's end: the molecular virial pressure
        by autograd of the block's energy (its neighbour state) with
        respect to the scaling, then each molecule moved by (mu - 1) COM and
        the box by mu, constraints re-applied. Returns (x, box)."""
        baro = self.cfg.barostat_cfg
        top = self.top
        x_new, box_new, p = berendsen_scale_chunk(
            lambda x_, b_, c_: self._energy_nbr(x_, b_, c_, nbr), x, box, v,
            top.masses, top.dof_mask, couple, baro.pressure_target,
            baro.tau, dt_eff, mol_id=top.mol_id, n_mol=top.n_mol)
        x_new, box_new = x_new.detach(), box_new.detach()
        if self._cp is not None:
            x_new = self._cp(x_new, x_new)
        self._last_pressure = p.detach()
        self.pressure_log.append((step, float(p), float(box_new[0])))
        return x_new, box_new

    def _step_hostloop(self, dt, n_steps, record_energy, force_cap):
        s = self.state
        x, v, box, couple = s.positions, s.velocities, s.box, s.couple
        gen = s.generator
        ext = self._external_forces_fn
        k = self.cfg.neighbor_rebuild_every
        ic = self.cfg.integrator
        langevin = ic.kind == "langevin_middle"
        csvr = not langevin and ic.thermostat_tau is not None
        baro = self.cfg.barostat_cfg
        # a block start renews the neighbour state and the force; the
        # allpairs and window paths have none to renew, so without a
        # barostat their force carries over
        renew = self._nbr_backend in ("pallas", "clusters") \
            or baro is not None
        energies, ovfs = [], []
        one = nbr = f = None
        for i in range(n_steps):
            if i % k == 0 and (i == 0 or renew):
                if i > 0 and baro is not None:
                    x, box = self._barostat(x, v, box, couple, nbr, dt * k,
                                            s.step + i)
                nbr, ovf = self._rebuild_nbr(apply_virtual_sites(x, self.top),
                                             box)
                if ovf is not None:
                    ovfs.append(ovf)

                def force(x_, nbr=nbr, box=box):
                    f_, rest = self._force_nbr(x_, box, couple, nbr)
                    if ext is not None:
                        f_ = f_ + ext(x_)
                    return f_, rest

                f = force(x)[0]
                one = self._make_one_step(dt, force, force_cap)
            if langevin:
                noise = torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                    device=x.device)
            elif csvr:
                noise = csvr_draws(gen, self._ndof, x.dtype, x.device)
            else:
                noise = None
            x, v, f, e, terms = one(x, v, f, noise)
            ovfs.append(terms["cell_overflow"])
            if record_energy:
                energies.append(e)
        if baro is not None and n_steps > 0:
            last = n_steps - k * ((n_steps - 1) // k)
            x, box = self._barostat(x, v, box, couple, nbr, dt * last,
                                    s.step + n_steps)
        ovf_max = int(torch.stack(ovfs).max()) if ovfs else 0
        if self.cfg.zero_com_drift:
            v = remove_com_drift(v, self.top.masses, self.top.dof_mask)
        x = apply_virtual_sites(x, self.top)
        _, (e_final, terms) = self.force_fn(x, box, couple)
        ke = kinetic_energy(v, self.top.masses, self.top.dof_mask)
        self.state = s.replace(positions=x, velocities=v, box=box,
                               step=s.step + n_steps, pe_last=e_final,
                               ke_last=ke,
                               dhdl_last=self.dhdl_fn(x, box, couple))
        self._last_terms = terms
        if ovf_max > 0:
            if self._nbr_backend == "clusters":
                raise ClusterOverflowError(
                    f"cluster-list overflow: a row needs {ovf_max} more "
                    f"than M = {self._plan.m_neighbors} neighbours")
            raise CellOverflowError(
                f"cell-list overflow: {ovf_max} atoms dropped from binning")
        return torch.stack(energies) if energies else None

    def step(self, dt_ps: float, n_steps: int = 1, record_energy=False,
             force_cap=None):
        """Advance exactly n_steps of dt_ps (ps). `force_cap` clamps
        per-atom forces (kcal/mol/A). On an overflow the call restarts
        from its first state after a replan (the cluster list 1.5x wider),
        up to 3 attempts."""
        t0 = time.perf_counter()
        try:
            with torch.no_grad():
                for attempt in range(3):
                    saved = self.state
                    gen_state = saved.generator.get_state()
                    n_log = len(self.pressure_log)
                    try:
                        energies = self._step_hostloop(
                            float(dt_ps), n_steps, record_energy, force_cap)
                        break
                    except (CellOverflowError, ClusterOverflowError) as ov:
                        if attempt == 2:
                            raise
                        self.state = saved
                        saved.generator.set_state(gen_state)
                        del self.pressure_log[n_log:]
                        if isinstance(ov, ClusterOverflowError):
                            self._m_scale *= 1.5
                        self.rebuild_neighbor_plan()
        finally:
            self._wall_time += time.perf_counter() - t0
        self._sim_time_ps += dt_ps * n_steps
        return energies

    def run(self, dt_ps: float, n_steps: int,
            snapshot_interval: Optional[int] = None, collect=True):
        """Blocking run: step calls of at most min(steps_per_chunk,
        snapshot_interval) steps (the reference's chunking), a Snapshot
        appended to `snapshots` whenever the steps done reach a multiple of
        snapshot_interval (default the config's in-memory interval, else
        n_steps). With cfg.trace_dir set, the run is traced by
        torch.profiler and its Chrome trace written there. Returns the
        snapshot list."""
        if snapshot_interval is None:
            snapshot_interval = self.cfg.snapshot_handlers.memory or n_steps

        def record(done):
            if collect and done % snapshot_interval == 0:
                self._record_snapshot(dt_ps)

        run_in_chunks(self, dt_ps, n_steps,
                      min(self.cfg.steps_per_chunk, snapshot_interval),
                      record, "mdsim_run")
        return self.snapshots

    def _record_snapshot(self, dt_ps):
        self.snapshots.append(snapshot_from_state(
            self.state, self.top, self._last_terms, dt_ps))

    def flush_snapshot_queues(self):
        """The snapshots recorded so far (reference
        MdState::flush_snapshot_queues)."""
        return self.snapshots

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
        with torch.no_grad():
            e, terms = self.force_fn(s.positions, s.box, s.couple)[1]
        self._last_terms = terms
        return float(e)

    def total_energy(self) -> float:
        return self.potential_energy() + self._kinetic_np()

    @torch.no_grad()
    def direct_space_scales(self, x):
        """The float32 scales of the direct-space backend's output at
        positions x (pallas and clusters), from its plain version's stats:
        per atom, the sum over its pairs of the pair-force term magnitudes
        (M-site rows spread onto O/H1/H2 as the force is); and for the "lj"
        and "coulomb" energy terms, the half sums of |e_lj| and |e_c| over
        all pairs. Both hold the excluded solute pairs that the rest energy
        subtracts again, which is where float32 leaves its largest
        residue."""
        from ..ops.direct_force import direct_force_plain

        s = self.state
        top = self.top
        xv = apply_virtual_sites(x, top)
        stats = {}
        if self._nbr_backend == "pallas":
            sa, inv, _ = self._rebuild(xv, s.box)
            center, ghost = self._direct.inputs(xv, s.box, sa)
            direct_force_plain(center, ghost, self._direct.starts, s.couple,
                               self._beta, self._direct.rc2, stats=stats)
            a = (stats["f_abs"][inv] * top.atom_mask)[:, None]
        elif self._nbr_backend == "clusters":
            order, nbr, _ = self._rebuild(xv, s.box)
            self._direct(xv, s.box, s.couple, self._beta, order, nbr,
                         want_force=False, stats=stats)
            a = stats["f_abs"][:, None]
        else:
            raise ValueError(f"no direct-space scales for backend "
                             f"{self._nbr_backend!r}")
        vs = top.vsite_idx
        am = a[vs[:, 0]] * top.vsite_mask[:, None]
        for col in (1, 2, 3):
            a = a.index_add(0, vs[:, col], am)
        return a[:, 0], {"lj": stats["e_abs_lj"],
                         "coulomb": stats["e_abs_c"]}


def compute_energy_snapshot(top, cfg: MdConfig, x, box_extent=None,
                            method=None, couple=1.0, device=None) -> dict:
    """Single-point energy with its per-term breakdown (reference
    compute_energy_snapshot), as floats; "cells_pme" on the cell window
    with PME. `device` None means the CUDA card."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    x = np.asarray(_np(x) if torch.is_tensor(x) else x, cfg.dtype)
    top = top.to(dev, dtype)
    sim_method = method or select_method(box_extent, x.shape[0], cfg)
    direct_fn = recip_fn = None
    if sim_method == "cells_pme":
        direct_fn = make_cell_direct_space_fn(top, cfg,
                                              np.asarray(box_extent), x0=x)
        recip_fn = make_pme_recip_fn(top, cfg, np.asarray(box_extent),
                                     device=dev)
    e_fn = make_energy_fn(top, cfg, sim_method, pme_recip_fn=recip_fn,
                          direct_space_fn=direct_fn)
    box = (None if box_extent is None else
           torch.as_tensor(np.asarray(box_extent, cfg.dtype), device=dev))
    with torch.no_grad():
        _, terms = e_fn(torch.as_tensor(x, device=dev), box,
                        torch.tensor(couple, dtype=dtype, device=dev))
    return {k: float(v) for k, v in terms.items()}
