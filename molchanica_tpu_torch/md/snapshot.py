"""Snapshot: host-side trajectory frames (port of molchanica_tpu.md.snapshot).

The reference layout: time, solute atom positions, water stored as
separate O/H0/H1 arrays, the per-frame energy triple (potential /
nonbonded / bonded), and a hydrogen-bond slot for later analysis.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class EnergyData:
    energy_potential: float
    energy_potential_nonbonded: float
    energy_potential_bonded: float


@dataclass
class Snapshot:
    time: float                      # ps
    atom_posits: np.ndarray          # [n_solute, 3] (MdSim) or [n, 3]
    water_o_posits: Optional[np.ndarray] = None
    water_h0_posits: Optional[np.ndarray] = None
    water_h1_posits: Optional[np.ndarray] = None
    energy_data: Optional[EnergyData] = None
    hydrogen_bonds: list = field(default_factory=list)
    dhdl: Optional[float] = None     # alchemical dH/dlambda at this frame
    kinetic_energy: Optional[float] = None
    box_extent: Optional[np.ndarray] = None


def snapshot_from_state(state, top, terms, dt_ps) -> Snapshot:
    """A Snapshot of an MdSim state: the solute rows, the waters' O / H0 /
    H1 rows, the energy triple of `terms` (the last finalize's), dH/dlambda,
    the kinetic energy and the box."""
    def host(t):
        return t.detach().cpu().numpy()

    x = host(state.positions)
    ws, wc, stride = top.water_start, top.water_count, top.water_site_count
    if wc > 0:
        solute = x[:ws]
        waters = x[ws:ws + wc * stride].reshape(wc, stride, 3)
        wo, wh0, wh1 = waters[:, 0], waters[:, 1], waters[:, 2]
    else:
        solute = x[:top.n_atoms_real]
        wo = wh0 = wh1 = None
    e = EnergyData(
        energy_potential=float(terms["energy_potential"]),
        energy_potential_nonbonded=float(terms["energy_potential_nonbonded"]),
        energy_potential_bonded=float(terms["energy_potential_bonded"]),
    ) if terms is not None else None
    return Snapshot(
        time=float(state.step) * dt_ps, atom_posits=solute,
        water_o_posits=wo, water_h0_posits=wh0, water_h1_posits=wh1,
        energy_data=e, dhdl=float(state.dhdl_last),
        kinetic_energy=float(state.ke_last),
        box_extent=None if state.box is None else host(state.box))


def run_in_chunks(sim, dt_ps, n_steps, chunk, record, trace_name):
    """The blocking run loop of MdSim and FastSim: sim.step(dt_ps, k) in
    calls of at most `chunk` steps, record(done) after each with the steps
    done so far. With sim.cfg.trace_dir set, the whole run is traced by
    torch.profiler and its Chrome trace written there as
    <trace_name>_<step count>.json."""
    prof = contextlib.nullcontext()
    if sim.cfg.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if sim.device.type == "cuda" else [])
        prof = profile(activities=acts)
    done = 0
    with prof:
        while done < n_steps:
            todo = min(chunk, n_steps - done)
            sim.step(dt_ps, todo)
            done += todo
            record(done)
    if sim.cfg.trace_dir:
        os.makedirs(sim.cfg.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            sim.cfg.trace_dir, f"{trace_name}_{sim.step_count}.json"))
