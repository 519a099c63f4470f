"""Hydration free energy + solvation descriptors (port of
molchanica_tpu.properties.water_sol): `run_sol_sim`, every lambda window a
replica of one ReplicaFarm over MdSim, and `run_sol_sim_fast`, the windows
one after another on FastSim.

Reference: `run_sol_sim` (src/properties/water_sol.rs:691) — solvated-MD
descriptors plus 13-window thermodynamic integration (lambda list at :55,
5k equil + 20k prod steps per window at :51-52, 35 A cube at :50), windows
run one after another (:583-612).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..md.alchemical import (HYDRATION_BOX_SIDE, HYDRATION_EQUIL_STEPS,
                             HYDRATION_LAMBDAS, HYDRATION_PROD_STEPS,
                             LambdaWindow, free_energy_ti_with_sem)
from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..molecules.spec import MolSpec, assemble_system
from ..systems.water import OPC


@dataclass
class WaterSolMdProperties:
    """Result bundle (reference WaterSolMdProperties, water_sol.rs:80)."""
    dg_hydration_kcal: float
    dg_sem_kcal: float
    mean_coupled_interaction_kcal: float
    mean_n_water_contacts: float
    mean_n_h_bonds: float
    windows: List[LambdaWindow] = field(default_factory=list)
    # the engine's account of the run. run_sol_sim_fast: force_evals
    # (every evaluation, the dhdl ones included), window_steps and
    # window_step_s (the lambda windows' step calls, host clock; dhdl
    # excluded), temperature_K after the last window. run_sol_sim:
    # farm_steps and farm_s (the farm's step calls, host clock),
    # farm_force_evals (batched), sim_force_evals (relaxation and warm-up),
    # the relaxation's log, the temperature after the warm-ups, each
    # replica's final temperature, whether every final position is finite
    run_metrics: dict = field(default_factory=dict)


def hydration_setup(mol: MolSpec, box_side: float = HYDRATION_BOX_SIDE,
                    temp: float = 310.0, seed: int = 0, water_model=OPC,
                    cfg_overrides: Optional[dict] = None):
    """(AssembledSystem, MdConfig) of the hydration protocol: the solute
    centred in a water box as the coupled molecule 0, Langevin-middle
    (gamma 1/ps) at `temp`, SHAKE on X-H, a 9 A cutoff, rebuild every 20
    steps."""
    box = np.array([box_side] * 3)
    mol = mol.translated(box / 2.0 - np.asarray(mol.positions).mean(axis=0))
    asys = assemble_system([mol], box_extent=box, water_model=water_model,
                           alchemical_mol=0, seed=seed)
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=1.0),
        temp_target=temp, lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float32", max_init_relaxation_iters=None,
        neighbor_rebuild_every=20, seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    return asys, MdConfig(**cfg_kw)


def run_sol_sim(
    mol: MolSpec,
    box_side: float = HYDRATION_BOX_SIDE,
    lambdas: Optional[List[float]] = None,
    equil_steps: int = HYDRATION_EQUIL_STEPS,
    prod_steps: int = HYDRATION_PROD_STEPS,
    dt_ps: float = 0.002,
    temp: float = 310.0,
    devices=None,
    seed: int = 0,
    dhdl_interval: int = 10,
    water_model=OPC,
    cfg_overrides: Optional[dict] = None,
    device=None,
) -> WaterSolMdProperties:
    """Hydration TI with every lambda window a replica of one batched
    ReplicaFarm (`mol` a parameterized MolSpec). The solute is centred in
    a water box as the coupled molecule 0; MdSim relaxes it (FIRE over
    400 iterations) and runs two capped warm-ups at full coupling; the
    farm then equilibrates every window for equil_steps and samples
    dH/dlambda on one recorded step after every dhdl_interval steps of
    production. Descriptors come from the fully coupled replica. On
    `device` (None: the CUDA card); `devices` cuts the replica axis over
    several (parallel/replicas.py). Scale equil_steps, prod_steps,
    box_side and lambdas down for tests; the defaults are the reference
    protocol's (water_sol.rs:50-55)."""
    import time

    from ..md.engine import MdSim
    from ..parallel.replicas import ReplicaFarm

    lambdas = lambdas if lambdas is not None else HYDRATION_LAMBDAS
    box = np.array([box_side] * 3)
    mol = mol.translated(box / 2.0 - np.asarray(mol.positions).mean(axis=0))
    asys = assemble_system([mol], box_extent=box, water_model=water_model,
                           alchemical_mol=0, seed=seed)
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=1.0),
        temp_target=temp, lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float32", max_init_relaxation_iters=400,
        steps_per_chunk=100, seed=seed,
    )
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    cfg = MdConfig(**cfg_kw)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, device=device)

    # gentle capped warmup at full coupling before fanning out
    sim.step(0.0005, min(400, equil_steps), force_cap=1000.0)
    sim.step(0.001, min(400, equil_steps), force_cap=3000.0)
    warm_t = sim.temperature()

    couples = 1.0 - np.asarray(lambdas)
    farm = ReplicaFarm(sim, len(lambdas), couples=couples, devices=devices,
                       seed=seed)
    t0 = time.perf_counter()
    # per-window equilibration (no dhdl recording)
    farm.step(dt_ps, equil_steps)
    # production with dH/dlambda sampling
    done = 0
    while done < prod_steps:
        todo = min(dhdl_interval, prod_steps - done)
        farm.step(dt_ps, todo)
        farm.step(dt_ps, 1, record_dhdl=True)
        done += todo + 1
    farm_s = time.perf_counter() - t0
    windows = farm.windows()
    dg, sem = free_energy_ti_with_sem(windows)

    # descriptors from the fully-coupled replica (index of lambda=0)
    i0 = int(np.argmin(np.asarray(lambdas)))
    x0 = farm.x[i0].detach().cpu().numpy()
    contacts, hbonds = _water_contact_stats(asys, x0)
    coupled_mean = float(np.mean(windows[i0].dhdl_samples)) \
        if len(windows[i0].dhdl_samples) else float("nan")
    return WaterSolMdProperties(
        dg_hydration_kcal=-dg,   # decoupling dG -> hydration dG sign
        dg_sem_kcal=sem,
        mean_coupled_interaction_kcal=coupled_mean,
        mean_n_water_contacts=contacts,
        mean_n_h_bonds=hbonds,
        windows=windows,
        run_metrics=dict(
            farm_steps=farm.step_count, farm_s=farm_s,
            farm_force_evals=farm.force_evals,
            sim_force_evals=sim.force_evals, relax=sim.relax_log,
            warmup_temperature_K=warm_t,
            temperatures_K=farm.temperatures().tolist(),
            finite=bool(np.isfinite(farm.x.detach().cpu().numpy()).all()),
            n_replicas=farm.n, n_sites=int(asys.topology.n_atoms_real)),
    )


def run_sol_sim_fast(
    mol: MolSpec,
    box_side: float = HYDRATION_BOX_SIDE,
    lambdas: Optional[List[float]] = None,
    equil_steps: int = HYDRATION_EQUIL_STEPS,
    prod_steps: int = HYDRATION_PROD_STEPS,
    dt_ps: float = 0.002,
    temp: float = 310.0,
    seed: int = 0,
    dhdl_interval: int = 20,
    water_model=OPC,
    verbose: bool = False,
    cfg_overrides: Optional[dict] = None,
    device="cuda",
) -> WaterSolMdProperties:
    """Hydration TI on FastSim: the solute is centred in a water box and
    decoupled (alchemical_mol=0), minimized, warmed up with capped forces
    at full coupling, then every lambda window runs in turn from the
    previous window's state: equilibration, then production with one
    dH/dlambda sample every `dhdl_interval` steps. On `device` (the CUDA
    card unless the caller asks for the CPU)."""
    import time

    from ..md.fast_engine import FastSim

    lambdas = list(lambdas if lambdas is not None else HYDRATION_LAMBDAS)
    asys, cfg = hydration_setup(mol, box_side, temp, seed, water_model,
                                cfg_overrides)
    sim = FastSim(asys.topology, cfg, asys.positions,
                  box_extent=asys.box_extent, device=device)
    sim.minimize(300)
    sim.step(0.0005, 200, force_cap=1000.0)
    sim.step(0.001, 200, force_cap=3000.0)

    windows: List[LambdaWindow] = []
    coupled_frames: List[np.ndarray] = []
    t0 = time.perf_counter()
    step_s = 0.0
    lam_min = min(lambdas)
    for lam in sorted(lambdas):
        sim.configure_alchemical_window(lam)
        t1 = time.perf_counter()
        sim.step(dt_ps, equil_steps)
        step_s += time.perf_counter() - t1
        samples = []
        done = 0
        while done < prod_steps:
            todo = min(dhdl_interval, prod_steps - done)
            t1 = time.perf_counter()
            sim.step(dt_ps, todo)
            step_s += time.perf_counter() - t1
            samples.append(sim.dhdl())
            done += todo
            # water contacts over the coupled window's production run, up
            # to ~8 frames (the reference analyses every snapshot,
            # water_sol.rs:273)
            if lam == lam_min and len(coupled_frames) < 8 and \
                    done % max(prod_steps // 8, dhdl_interval) < \
                    dhdl_interval:
                coupled_frames.append(sim.positions_unsorted())
        windows.append(LambdaWindow(lam=lam,
                                    dhdl_samples=np.asarray(samples)))
        if verbose:
            print(f"[ti-fast] lambda={lam:.3f} <dH/dl>="
                  f"{np.mean(samples):.3f} "
                  f"({time.perf_counter()-t0:.0f}s)", flush=True)
    windows.sort(key=lambda w: w.lam)
    dg, sem = free_energy_ti_with_sem(windows)
    if not coupled_frames:
        coupled_frames.append(sim.positions_unsorted())
    per_frame = [_water_contact_stats(asys, xf) for xf in coupled_frames]
    contacts = float(np.mean([c for c, _ in per_frame]))
    hbonds = float(np.mean([h for _, h in per_frame]))
    i0 = int(np.argmin([w.lam for w in windows]))
    coupled_mean = float(np.mean(windows[i0].dhdl_samples)) \
        if len(windows[i0].dhdl_samples) else float("nan")
    return WaterSolMdProperties(
        dg_hydration_kcal=-dg,   # decoupling dG -> hydration dG sign
        dg_sem_kcal=sem,
        mean_coupled_interaction_kcal=coupled_mean,
        mean_n_water_contacts=contacts,
        mean_n_h_bonds=hbonds,
        windows=windows,
        run_metrics=dict(
            force_evals=sim.force_evals,
            window_steps=len(lambdas) * (equil_steps + prod_steps),
            window_step_s=step_s, temperature_K=sim.temperature(),
            n_sites=int(asys.topology.n_atoms_real)),
    )


def _water_contact_stats(asys, x, contact_r: float = 3.5,
                         hb_r: float = 2.6):
    """First-shell water contacts + donor/acceptor-weighted H-bond count for
    the solute (reference's per-snapshot water analysis, water_sol.rs:273)."""
    top = asys.topology
    n_solute = asys.n_solute_atoms
    ws = top.water_start
    wc = top.water_count
    sc = top.water_site_count
    if wc == 0 or n_solute == 0:
        return 0.0, 0.0
    box = np.asarray(asys.box_extent)
    xs = x[:n_solute]
    xw = x[ws:ws + wc * sc].reshape(wc, sc, 3)
    wo = xw[:, 0]                      # oxygens
    d = xs[:, None, :] - wo[None, :, :]
    d -= box * np.round(d / box)
    r = np.linalg.norm(d, axis=-1)
    contacts = float((r < contact_r).sum())
    # crude H-bond proxy: polar solute atoms (|q| > 0.3) near water O/H
    q = np.asarray(top.charges)[:n_solute]
    polar = np.abs(q) > 0.3
    hb = float((r[polar] < hb_r + 0.6).sum()) if polar.any() else 0.0
    return contacts, hb
