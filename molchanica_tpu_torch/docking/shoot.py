"""Docking v2: MD-shooting dock (port of molchanica_tpu.docking.shoot).

Reference parity: src/docking/mod.rs dock() — the ligand is placed
`start_dist` A out along the site normal and shot at the pocket with a
large initial velocity (120 A/ps), then MD (dt 2 fs, ~800 steps) carries
it in; binding is scored from the interaction energy along the way.

Each shot is one MdSim (vacuum: method allpairs) on `device`; the shot is
added to the ligand's velocities on the device, and the interaction energy
is read on the host from the positions after each of 16 chunks, as in the
reference. `dock_md_multi` runs its shots one after another, as the
reference's code does (its module docstring speaks of vmapped shots; the
code is a serial loop).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..constants import COULOMB_CONST
from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..md.engine import MdSim
from ..molecules.spec import MolSpec, assemble_system

START_DIST = 8.0          # A (dock(), docking/mod.rs)
SHOOT_SPEED = 120.0       # A/ps


@dataclass
class ShootResult:
    best_interaction_kcal: float
    final_interaction_kcal: float
    interaction_trace: np.ndarray
    min_site_distance: float
    ligand_final: np.ndarray = field(repr=False, default=None)


def _interaction_energy(x, rec_rows, lig_rows, charges, sig, eps,
                        cutoff=10.0):
    """Receptor-ligand LJ+Coulomb interaction (dense cross-group)."""
    xr = x[rec_rows]
    xl = x[lig_rows]
    d = xr[:, None, :] - xl[None, :, :]
    r2 = np.sum(d * d, axis=-1)
    r2 = np.maximum(r2, 0.25)
    mask = r2 < cutoff * cutoff
    r = np.sqrt(r2)
    s = 0.5 * (sig[rec_rows][:, None] + sig[lig_rows][None, :])
    e4 = 4.0 * np.sqrt(eps[rec_rows][:, None] * eps[lig_rows][None, :])
    s6 = np.clip((s * s / r2) ** 3, 0, 1e4)
    e_lj = e4 * (s6 * s6 - s6)
    e_c = COULOMB_CONST * charges[rec_rows][:, None] \
        * charges[lig_rows][None, :] / r
    return float(np.sum(np.where(mask, e_lj + e_c, 0.0)))


def shot_system(receptor: MolSpec, ligand: MolSpec, site, approach,
                start_dist: float = START_DIST, seed: int = 0):
    """The assembled receptor + ligand of a shot: the ligand's centroid
    start_dist out from the site along the unit `approach`, pushed further
    out in steps of 0.5 A until every ligand atom is more than 2.8 A from
    the receptor."""
    lig = copy.copy(ligand)
    lig_com = np.asarray(ligand.positions).mean(axis=0)
    start = site + approach * start_dist
    # push the start out until the ligand clears the receptor surface
    # (the reference's site is a surface pocket, 8 A out is free space;
    # for a centroid site the line starts inside the envelope)
    rec_xyz = np.asarray(receptor.positions)
    lig_rel = np.asarray(ligand.positions) - lig_com
    for _ in range(60):
        d = np.linalg.norm(
            rec_xyz[:, None, :] - (lig_rel + start)[None, :, :], axis=-1)
        if d.min() > 2.8:
            break
        start = start + approach * 0.5
    lig.positions = lig_rel + start
    return assemble_system([receptor, lig], relieve_clashes=False, seed=seed)


def shot_config(n_steps: int = 800, seed: int = 0,
                cfg_overrides: Optional[dict] = None) -> MdConfig:
    """A shot's MdConfig: Langevin-middle (gamma 2) at 300 K, flexible
    X-H (dock()'s choice), float32, FIRE 200 at construction, no COM-drift
    removal, chunks of n_steps / 16; `cfg_overrides` replace fields."""
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=2.0),
        temp_target=300.0,
        hydrogen_constraint=HydrogenConstraint.flexible(),  # dock() choice
        dtype="float32", max_init_relaxation_iters=200,
        zero_com_drift=False, steps_per_chunk=max(n_steps // 16, 1),
        seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    return MdConfig(**cfg_kw)


def dock_md(receptor: MolSpec, ligand: MolSpec,
            site_center: Optional[np.ndarray] = None,
            approach: Optional[np.ndarray] = None,
            start_dist: float = START_DIST, speed: float = SHOOT_SPEED,
            n_steps: int = 800, dt_ps: float = 0.002,
            seed: int = 0, cfg_overrides: Optional[dict] = None,
            device=None) -> ShootResult:
    """One MD shot (reference dock(), docking/mod.rs:81) on `device`
    (None: the CUDA card)."""
    rec_com = np.asarray(receptor.positions).mean(axis=0)
    site = np.asarray(site_center, float) if site_center is not None \
        else rec_com
    if approach is None:
        approach = site - rec_com
        n = np.linalg.norm(approach)
        approach = approach / n if n > 1e-6 else np.array([1.0, 0, 0])
    approach = np.asarray(approach, float)
    approach = approach / np.linalg.norm(approach)

    asys = shot_system(receptor, ligand, site, approach, start_dist, seed)
    n_rec = receptor.n_atoms
    n_lig = ligand.n_atoms
    rec_rows = np.arange(n_rec)
    lig_rows = np.arange(n_rec, n_rec + n_lig)

    cfg = shot_config(n_steps, seed, cfg_overrides)
    sim = MdSim(asys.topology, cfg, asys.positions, device=device)
    # shoot: ligand initial velocity toward the site, added in float64 and
    # rounded to the state's dtype (the reference's numpy in-place add)
    v = sim.state.velocities.double()
    lig_t = torch.as_tensor(lig_rows, device=v.device)
    v[lig_t] += torch.as_tensor(-approach * speed, device=v.device)
    sim.state = sim.state.replace(velocities=v.to(sim.dtype))

    charges = asys.topology.charges.numpy()
    sig = asys.topology.lj_sigma.numpy()
    eps = asys.topology.lj_eps.numpy()

    trace = []
    min_dist = np.inf
    chunk = max(n_steps // 16, 1)
    done = 0
    while done < n_steps:
        sim.step(dt_ps, min(chunk, n_steps - done))
        done += chunk
        x = sim.state.positions.detach().cpu().numpy()
        trace.append(_interaction_energy(x, rec_rows, lig_rows,
                                         charges, sig, eps))
        d = np.linalg.norm(x[lig_rows].mean(axis=0) - site)
        min_dist = min(min_dist, float(d))
    trace = np.asarray(trace)
    return ShootResult(
        best_interaction_kcal=float(trace.min()),
        final_interaction_kcal=float(trace[-1]),
        interaction_trace=trace,
        min_site_distance=min_dist,
        ligand_final=x[lig_rows])


def dock_md_multi(receptor: MolSpec, ligand: MolSpec,
                  n_shots: int = 8, **kw) -> List[ShootResult]:
    """Shots from a Fibonacci sphere of approach vectors, one after
    another; best-first."""
    rec_com = np.asarray(receptor.positions).mean(axis=0)
    site = kw.pop("site_center", rec_com)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    out = []
    for k in range(n_shots):
        z = 1.0 - 2.0 * (k + 0.5) / n_shots
        r = np.sqrt(max(1.0 - z * z, 0.0))
        th = golden * k
        approach = np.array([r * np.cos(th), r * np.sin(th), z])
        out.append(dock_md(receptor, ligand, site_center=site,
                           approach=approach, seed=k, **kw))
    return sorted(out, key=lambda s: s.best_interaction_kcal)
