"""Shrinking-box solvent packing / solubility MD (port of
molchanica_tpu.properties.shrinking_box).

Reference parity: run_shrinking_box_sim (src/properties/sol_shrinking_box.rs:1472)
— molecules start dilute in an oversized box which is stepped down toward a
target density during MD, producing (a) a packed solvent/solution box and
(b) mixing/solubility descriptors along the trajectory.

The box scale is applied between MdSim step calls (the box is state, the
force paths read it at every call).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..md.engine import MdSim
from ..molecules.spec import MolSpec, assemble_system
from .mixing import SolubilityMixingDiagnostics, mixing_diagnostics


@dataclass
class ShrinkingBoxMdData:
    """Result bundle (reference ShrinkingBoxMdData,
    sol_shrinking_box.rs:193)."""
    final_box_side_a: float
    final_density_g_cm3: float
    target_density_g_cm3: float
    mixing: Optional[SolubilityMixingDiagnostics]
    temperature_k: float
    shrink_steps: int
    positions: np.ndarray = field(repr=False, default=None)


PRESSURE_CAP_BAR = 20_000.0       # reference shrink stop (rs:140)


def run_shrinking_box_sim(
    mols: List[MolSpec],
    target_density_g_cm3: float = 0.95,
    start_scale: float = 1.6,
    shrink_per_stage: float = 0.96,
    steps_per_stage: int = 200,
    dt_ps: float = 0.001,
    temp: float = 300.0,
    seed: int = 0,
    solute_indices: Optional[List[int]] = None,
    cfg_overrides: Optional[dict] = None,
    mode: str = "homogeneous",
    pressure_cap_bar: Optional[float] = PRESSURE_CAP_BAR,
    device=None,
) -> ShrinkingBoxMdData:
    """Pack `mols` to the target density by staged box shrinking.

    mode="homogeneous": dilute 3D grid start (reference default).
    mode="slab": solute copies start in a z-slab with the rest above it
    (the reference's layer mode, sol_shrinking_box.rs:85-104) — used for
    boundary-layer/interface experiments.
    A shrink stage is skipped (schedule ends) once the instantaneous
    pressure exceeds `pressure_cap_bar` (reference cap 20 kbar, rs:140).
    On `device` (None: the CUDA card).
    """
    mw_total = sum(float(np.sum(m.masses)) for m in mols)
    v_target = mw_total / (target_density_g_cm3 * 0.6022)
    side_target = v_target ** (1.0 / 3.0)
    side = side_target * start_scale

    # dilute start: 3D grid, or solute-slab/other-slab split
    rng = np.random.default_rng(seed)
    n = len(mols)
    placed = []
    if mode == "slab":
        sol_set = set(solute_indices or range(n))
        lo = [i for i in range(n) if i in sol_set]
        hi = [i for i in range(n) if i not in sol_set]
        cells = {}
        for group, z0, z1 in ((lo, 0.15, 0.45), (hi, 0.55, 0.9)):
            ns = max(1, int(np.ceil(np.sqrt(max(len(group), 1)))))
            for gi, mi in enumerate(group):
                gx, gy = gi % ns, (gi // ns) % ns
                z = z0 + (z1 - z0) * ((gi // (ns * ns)) + 0.5) \
                    / max(1, int(np.ceil(len(group) / (ns * ns))))
                cells[mi] = np.array([(gx + 0.5) / ns * side,
                                      (gy + 0.5) / ns * side, z * side])
        centers = [cells[i] for i in range(n)]
    else:
        n_side = int(np.ceil(n ** (1 / 3)))
        spacing = side / max(n_side, 1)
        grid = [(i, j, k) for i in range(n_side) for j in range(n_side)
                for k in range(n_side)][:n]
        centers = [(np.array(c) + 0.5) * spacing for c in grid]
    for m, ctr in zip(mols, centers):
        import copy as _copy
        m2 = _copy.copy(m)
        com = np.asarray(m.positions).mean(axis=0)
        m2.positions = np.asarray(m.positions) - com + ctr
        placed.append(m2)

    box = np.array([side] * 3)
    asys = assemble_system(placed, box_extent=box, seed=seed)
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=5.0),
        temp_target=temp,
        lj_cutoff=min(9.0, side_target / 2 - 0.1),
        coulomb_cutoff=min(9.0, side_target / 2 - 0.1),
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float64", max_init_relaxation_iters=200,
        steps_per_chunk=steps_per_stage, seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    cfg = MdConfig(**cfg_kw)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, device=device)

    shrink_steps = 0
    sim.step(dt_ps / 2, steps_per_stage, force_cap=1000.0)
    while float(sim.state.box[0]) > side_target:
        if pressure_cap_bar is not None \
                and _pressure_bar(sim) > pressure_cap_bar:
            break              # reference: stop compressing past the cap
        scale = max(shrink_per_stage,
                    side_target / float(sim.state.box[0]))
        st = sim.state
        sim.state = st.replace(positions=st.positions * scale,
                               box=st.box * scale)
        sim.step(dt_ps, steps_per_stage, force_cap=2000.0)
        shrink_steps += steps_per_stage
    sim.step(dt_ps, steps_per_stage)

    box_f = sim.state.box.detach().cpu().numpy()
    dens = mw_total / (0.6022 * float(np.prod(box_f)))
    x = sim.state.positions.detach().cpu().numpy()

    mixing = None
    if solute_indices:
        # per-molecule COMs: solutes vs the rest as "solvent"
        coms, others = [], []
        off = 0
        for mi, m in enumerate(placed):
            rows = x[off:off + m.n_atoms]
            if mi in solute_indices:
                coms.append(rows.mean(axis=0))
            else:
                others.append(rows)
            off += m.n_atoms
        if others and coms:
            mixing = mixing_diagnostics(
                np.asarray(coms), np.concatenate(others), box_f)

    return ShrinkingBoxMdData(
        final_box_side_a=float(box_f[0]),
        final_density_g_cm3=float(dens),
        target_density_g_cm3=target_density_g_cm3,
        mixing=mixing,
        temperature_k=float(sim.temperature()),
        shrink_steps=shrink_steps,
        positions=x,
    )


def _pressure_bar(sim) -> float:
    """Instantaneous virial pressure of an MdSim (bar)."""
    from ..md.barostat import instantaneous_pressure_bar

    st = sim.state
    with torch.no_grad():
        f, _ = sim.force_fn(st.positions, st.box, st.couple)
    return float(instantaneous_pressure_bar(
        st.positions, st.box, st.velocities, sim.top.masses,
        sim.top.dof_mask, f))


def run_on_select_mols(
    mol_lists: List[List[MolSpec]],
    solute_indices_per_run: Optional[List[List[int]]] = None,
    **kw,
) -> List[ShrinkingBoxMdData]:
    """Batch runner over independent packings (reference
    run_on_select_mols, sol_shrinking_box.rs:1699). Each entry is an
    independent system; runs execute sequentially here — replica-parallel
    dispatch belongs to parallel.replicas when shapes match."""
    out = []
    for i, mols in enumerate(mol_lists):
        si = solute_indices_per_run[i] if solute_indices_per_run else None
        out.append(run_shrinking_box_sim(mols, solute_indices=si, **kw))
    return out


def pack_to_density(mols: List[MolSpec], target_density_g_cm3: float = 0.95,
                    **kw):
    """Packing primitive (reference pack_solvent_with_shrinking_box_cfg):
    run the shrink schedule and return (positions, box_extent) for use as
    a starting configuration by other workloads."""
    data = run_shrinking_box_sim(mols, target_density_g_cm3, **kw)
    side = data.final_box_side_a
    return data.positions, np.array([side, side, side])
