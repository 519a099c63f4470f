"""Crystal / self-affinity estimation: dry multi-copy MD (port of
molchanica_tpu.properties.crystal).

Reference parity: run_crystal_sim (src/properties/crystal.rs:709) — N
copies of the molecule packed at a target density with NO solvent; the
run yields self-affinity descriptors (cohesive energy per molecule,
contact statistics, drift of density) used as crystallization propensity
features.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..md.engine import MdSim, compute_energy_snapshot
from ..molecules.spec import MolSpec, assemble_system


@dataclass
class CrystalData:
    """Self-affinity descriptors (reference CrystalData, crystal.rs:109)."""
    cohesive_energy_kcal_per_mol: float
    energy_total_kcal: float
    energy_isolated_kcal: float
    copy_count: int
    box_side_a: float
    target_density_g_cm3: float
    mean_intermolecular_contacts: float
    temperature_k: float


def crystal_md_setup(mol: MolSpec, target_density_g_cm3: float = 1.0,
                     requested_copies: int = 24):
    """Box side + copy count from the density target (crystal.rs setup)."""
    mw = float(np.sum(mol.masses))                      # g/mol
    # V(A^3) for N copies at rho: N * mw / (rho * 0.6022)
    n = requested_copies
    vol = n * mw / (target_density_g_cm3 * 0.6022)
    side = vol ** (1.0 / 3.0)
    # keep packing feasible: ~0.75x the molecule extent per cell is enough
    # (initial overlap is relieved by clash relaxation + capped warmup)
    ext = max(float(np.ptp(np.asarray(mol.positions), axis=0).max()), 2.0)
    n_side = max(int(side / (0.75 * ext)), 1)
    n_cap = n_side ** 3
    if n_cap < n:
        n = n_cap
        vol = n * mw / (target_density_g_cm3 * 0.6022)
        side = max(vol ** (1.0 / 3.0), ext * n_side)
    return n, side


def run_crystal_sim(
    mol: MolSpec,
    target_density_g_cm3: float = 1.0,
    requested_copies: int = 24,
    n_steps: int = 2000,
    dt_ps: float = 0.001,
    temp: float = 300.0,
    seed: int = 0,
    cfg_overrides: Optional[dict] = None,
    device=None,
):
    """Dry multi-copy NVT -> (CrystalData, snapshots). On `device` (None:
    the CUDA card)."""
    n, side = crystal_md_setup(mol, target_density_g_cm3,
                               requested_copies)
    rng = np.random.default_rng(seed)
    n_side = int(np.ceil(n ** (1 / 3)))
    spacing = side / n_side
    copies = []
    cells = [(i, j, k) for i in range(n_side) for j in range(n_side)
             for k in range(n_side)][:n]
    for (i, j, k) in cells:
        import copy as _copy
        m = _copy.copy(mol)
        com = np.asarray(mol.positions).mean(axis=0)
        # random orientation
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        m.positions = (np.asarray(mol.positions) - com) @ R.T + \
            (np.array([i, j, k]) + 0.5) * spacing
        copies.append(m)

    box = np.array([side] * 3)
    asys = assemble_system(copies, box_extent=box, seed=seed)
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=2.0),
        temp_target=temp, lj_cutoff=min(9.0, side / 2 - 0.1),
        coulomb_cutoff=min(9.0, side / 2 - 0.1),
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float64", max_init_relaxation_iters=300,
        steps_per_chunk=100, seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    cfg = MdConfig(**cfg_kw)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, device=device)
    sim.step(dt_ps / 2, min(200, n_steps), force_cap=1000.0)
    sim.step(dt_ps, n_steps)

    e_total = float(sim.state.pe_last)
    # isolated-molecule reference energy
    iso = assemble_system([mol])
    snap = compute_energy_snapshot(iso.topology, cfg, iso.positions,
                                   device=device)
    e_iso = snap["energy_potential"]
    cohesive = (e_total - n * e_iso) / n

    # intermolecular contacts (<4.0 A heavy-heavy) per molecule
    x = sim.state.positions.detach().cpu().numpy()
    nat = mol.n_atoms
    mask = np.asarray(asys.topology.atom_mask) > 0
    coms = []
    for c in range(n):
        rows = x[c * nat:(c + 1) * nat]
        coms.append(rows.mean(axis=0))
    coms = np.asarray(coms)
    d = coms[:, None] - coms[None]
    d -= box * np.round(d / box)
    r = np.linalg.norm(d, axis=-1) + np.eye(n) * 1e9
    contacts = float((r < (np.ptp(np.asarray(mol.positions)) + 4.0))
                     .sum() / n)

    data = CrystalData(
        cohesive_energy_kcal_per_mol=float(cohesive),
        energy_total_kcal=e_total,
        energy_isolated_kcal=float(e_iso),
        copy_count=n, box_side_a=float(side),
        target_density_g_cm3=target_density_g_cm3,
        mean_intermolecular_contacts=contacts,
        temperature_k=float(sim.temperature()),
    )
    return data, sim.snapshots
