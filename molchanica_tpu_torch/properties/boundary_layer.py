"""Boundary-layer (interfacial) solvation MD (port of
molchanica_tpu.properties.boundary_layer).

Reference parity: run_boundary_layer_sol_sim
(src/properties/water_sol_mix.rs:581) — the solute at a water slab /
vacuum interface; the z-resolved water density profile and the solute's
position relative to the Gibbs dividing surface report surface affinity
(positive surface excess = surfactant-like behavior).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..md.config import HydrogenConstraint, Integrator, MdConfig
from ..md.engine import MdSim
from ..molecules.spec import MolSpec, assemble_system
from ..systems.water import OPC


@dataclass
class BoundaryLayerMdData:
    """Result bundle (reference BoundaryLayerMdData,
    water_sol_mix.rs:64)."""
    gibbs_surface_z_a: float
    solute_depth_a: float              # solute COM depth below the surface
    surface_affinity: float            # fraction of frames near the surface
    density_profile: np.ndarray = field(repr=False, default=None)
    profile_z: np.ndarray = field(repr=False, default=None)
    temperature_k: float = 0.0


def run_boundary_layer_sol_sim(
    solute: MolSpec,
    slab_waters: int = 160,
    box_xy: float = 18.0,
    box_z: float = 50.0,
    n_steps: int = 1500,
    dt_ps: float = 0.001,
    temp: float = 300.0,
    seed: int = 0,
    cfg_overrides: Optional[dict] = None,
    device=None,
) -> BoundaryLayerMdData:
    """Water slab in the lower half of an elongated box + the solute at
    the interface; NVT; returns interfacial descriptors. On `device`
    (None: the CUDA card)."""
    slab_height = slab_waters * 34.0 / (box_xy * box_xy)   # ~bulk density + margin
    # place the solute just above the slab surface
    sol = solute.translated(
        np.array([box_xy / 2, box_xy / 2, slab_height + 2.0])
        - np.asarray(solute.positions).mean(axis=0))
    asys = assemble_system(
        [sol], box_extent=np.array([box_xy, box_xy, box_z]),
        water_model=OPC, n_waters=slab_waters, seed=seed,
        water_region=(np.zeros(3),
                      np.array([box_xy, box_xy, slab_height])))
    cfg_kw = dict(
        integrator=Integrator.langevin_middle(gamma=5.0),
        temp_target=temp, lj_cutoff=8.0, coulomb_cutoff=8.0,
        hydrogen_constraint=HydrogenConstraint.shake(),
        dtype="float64", max_init_relaxation_iters=200,
        steps_per_chunk=100, seed=seed)
    if cfg_overrides:
        cfg_kw.update(cfg_overrides)
    cfg = MdConfig(**cfg_kw)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent, device=device)

    sim.step(dt_ps / 2, 200, force_cap=1000.0)
    n_frames = 0
    surf_frames = 0
    depth_acc = 0.0
    nbins = 50
    prof = np.zeros(nbins)
    top = asys.topology
    w0 = top.water_start
    stride = top.water_site_count
    o_rows = w0 + stride * np.arange(top.water_count)
    nat = solute.n_atoms
    chunk = 150
    done = 0
    while done < n_steps:
        sim.step(dt_ps, chunk)
        done += chunk
        x = sim.state.positions.detach().cpu().numpy()
        zw = x[o_rows, 2] % box_z
        prof += np.histogram(zw, bins=nbins, range=(0, box_z))[0]
        # Gibbs surface: z where the density falls to half the bulk
        h, edges = np.histogram(zw, bins=nbins, range=(0, box_z))
        bulk = np.median(h[h > 0]) if (h > 0).any() else 1.0
        above = np.nonzero(h > 0.5 * bulk)[0]
        z_surf = edges[above.max() + 1] if above.size else slab_height
        z_sol = float(np.mean(x[:nat, 2])) % box_z
        depth_acc += z_surf - z_sol
        if abs(z_sol - z_surf) < 4.0:
            surf_frames += 1
        n_frames += 1

    z_centers = (np.arange(nbins) + 0.5) * box_z / nbins
    return BoundaryLayerMdData(
        gibbs_surface_z_a=float(z_surf),
        solute_depth_a=float(depth_acc / max(n_frames, 1)),
        surface_affinity=surf_frames / max(n_frames, 1),
        density_profile=prof / max(n_frames, 1),
        profile_z=z_centers,
        temperature_k=float(sim.temperature()),
    )
