"""LogP / LogD via dual-phase alchemical decoupling (port of
molchanica_tpu.properties.logp).

Reference: run_alchemical (src/properties/logp.rs:206) — TI decoupling in
water and in water-saturated octanol;
LogP = (dG_octanol - dG_water) / (2.303 R T)   (logp.rs log_p, :279).

Each phase runs all its lambda windows as the replicas of one batched
ReplicaFarm over MdSim (as properties/water_sol.py::run_sol_sim does)
instead of the reference's serial window loop.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..constants import KB
from ..md.alchemical import LambdaWindow, free_energy_ti_with_sem
from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..md.engine import MdSim
from ..molecules.spec import MolSpec, assemble_system
from ..parallel.replicas import ReplicaFarm
from ..systems.octanol import pack_octanol_box
from ..systems.water import OPC

LOGP_LAMBDAS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
TEMP_DEFAULT = 298.15


@dataclass
class FreeEnergyEstimate:
    dg_kcal_mol: float
    dg_sem_kcal_mol: float
    windows: List[LambdaWindow] = field(default_factory=list)
    # the run's account: n_sites, farm_steps and farm_s (the farm's step
    # calls, host clock), each replica's final temperature, whether every
    # final position is finite
    run_metrics: dict = field(default_factory=dict)


@dataclass
class LogPResult:
    logp: float
    water: FreeEnergyEstimate
    octanol: FreeEnergyEstimate
    temp_k: float


def log_p(dg_water: float, dg_octanol: float, temp_k: float) -> float:
    """LogP = (dG_octanol - dG_water) / (2.303 R T) (logp.rs:279)."""
    rt = KB * temp_k
    return (dg_octanol - dg_water) / (2.302585 * rt)


def _phase_free_energy(asys, lambdas, equil_steps, prod_steps, dt_ps,
                       temp, seed, dhdl_interval=10, cfg_overrides=None,
                       device=None) -> FreeEnergyEstimate:
    """One phase's decoupling free energy: MdSim relaxation and two capped
    warm-ups at full coupling, then every lambda window a replica of one
    ReplicaFarm (equilibration, then one recorded dH/dlambda step after
    every dhdl_interval production steps), TI with SEM."""
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=1.0),
        temp_target=temp, lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float32", max_init_relaxation_iters=400,
        steps_per_chunk=100, seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    cfg = MdConfig(**cfg_kw)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, device=device)
    sim.step(0.0005, min(400, equil_steps), force_cap=1000.0)
    sim.step(0.001, min(400, equil_steps), force_cap=3000.0)
    couples = 1.0 - np.asarray(lambdas)
    farm = ReplicaFarm(sim, len(lambdas), couples=couples, seed=seed)
    t0 = time.perf_counter()
    farm.step(dt_ps, equil_steps)
    done = 0
    while done < prod_steps:
        todo = min(dhdl_interval, prod_steps - done)
        farm.step(dt_ps, todo)
        farm.step(dt_ps, 1, record_dhdl=True)
        done += todo + 1
    farm_s = time.perf_counter() - t0
    windows = farm.windows()
    dg, sem = free_energy_ti_with_sem(windows)
    return FreeEnergyEstimate(dg, sem, windows, run_metrics=dict(
        n_sites=int(asys.topology.n_atoms_real), farm_steps=farm.step_count,
        farm_s=farm_s, temperatures_K=farm.temperatures().tolist(),
        finite=bool(torch.isfinite(farm.x).all())))


def run_alchemical(
    mol: MolSpec,
    water_box_side: float = 35.0,
    octanol_box_side: float = 30.0,
    lambdas: Optional[List[float]] = None,
    equil_steps: int = 500,
    prod_steps: int = 1000,
    dt_ps: float = 0.002,
    temp: float = TEMP_DEFAULT,
    seed: int = 0,
    cfg_overrides: Optional[dict] = None,
    device=None,
) -> LogPResult:
    """Dual-phase decoupling TI -> LogP (reference logp.rs:206).

    `mol` must be a parameterized MolSpec. Defaults mirror the reference
    constants (logp.rs:28-61); scale down for tests. On `device` (None:
    the CUDA card).
    """
    lambdas = lambdas if lambdas is not None else LOGP_LAMBDAS

    # water phase
    wbox = np.array([water_box_side] * 3)
    mw = mol.translated(wbox / 2 - np.asarray(mol.positions).mean(axis=0))
    asys_w = assemble_system([mw], box_extent=wbox, water_model=OPC,
                             alchemical_mol=0, seed=seed)
    water = _phase_free_energy(asys_w, lambdas, equil_steps, prod_steps,
                               dt_ps, temp, seed,
                               cfg_overrides=cfg_overrides, device=device)

    # wet-octanol phase
    obox = np.array([octanol_box_side] * 3)
    mo = mol.translated(obox / 2 - np.asarray(mol.positions).mean(axis=0))
    oct_mols, n_water = pack_octanol_box(octanol_box_side, seed=seed)
    asys_o = assemble_system([mo] + oct_mols, box_extent=obox,
                             water_model=OPC, n_waters=n_water,
                             alchemical_mol=0, seed=seed)
    octanol = _phase_free_energy(asys_o, lambdas, equil_steps, prod_steps,
                                 dt_ps, temp, seed,
                                 cfg_overrides=cfg_overrides, device=device)

    # decoupling dGs: logp from the difference
    lp = log_p(water.dg_kcal_mol, octanol.dg_kcal_mol, temp)
    return LogPResult(logp=lp, water=water, octanol=octanol, temp_k=temp)
