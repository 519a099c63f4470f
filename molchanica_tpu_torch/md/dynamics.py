"""High-level MD entry points with the reference's names (port of
molchanica_tpu.md.dynamics): `MolDynamics`, `FF_MOL_TYPE`, `add_copies`,
`build_dynamics`, `run_dynamics_blocking`, `MdHandle` and `launch_md`.

The quick start:

    mol = open_file("ligand.sdf")
    sim = build_dynamics([MolDynamics(elements=mol.elements,
                                      atom_posits=mol.positions,
                                      bonds=mol.bonds)], cfg)
    run_dynamics_blocking(sim, 0.002, 1000, 100)

Assembly (typing, parameters, copies, box, solvent) is the reference's
host code with the same seed, so the assembled system equals the JAX
package's bit for bit; the MdSim it builds runs on `device` (None means
the CUDA card).
"""
from __future__ import annotations

import copy
import math
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np

from ..ff.params import FfParamSet, merge_params
from ..molecules.common import MoleculeCommon
from ..molecules.spec import MolSpec, assemble_system
from ..systems.water import OPC, TIP3P
from .config import MdConfig
from .engine import MdSim

# reference FfMolType enum (src/md/mod.rs:1044-1071)
FF_MOL_TYPE = ("peptide", "small_organic", "dna", "rna", "lipid")


@dataclass
class MolDynamics:
    """Input molecule for MD (reference MolDynamics, src/md/mod.rs:1110).

    Either pass a parameterized `spec` directly, or raw structure fields
    (elements/atom_posits/bonds[, charges]) to be typed+parameterized on
    assembly.
    """
    ff_mol_type: str = "small_organic"
    elements: Optional[Sequence[str]] = None
    atom_posits: Optional[np.ndarray] = None
    atom_init_velocities: Optional[np.ndarray] = None
    bonds: Optional[Sequence] = None
    static_: bool = False
    bonded_only: bool = False
    mol_specific_params: object = None   # per-mol frcmod overlay
    spec: Optional[MolSpec] = None
    n_copies: int = 1               # reference `selected_for_md` copy count

    def to_spec(self, param_set: Optional[FfParamSet]) -> MolSpec:
        if self.spec is not None:
            s = self.spec
        else:
            mol = MoleculeCommon(
                elements=list(self.elements),
                positions=np.asarray(self.atom_posits),
                bonds=list(self.bonds or []))
            if not mol.bonds:
                mol.infer_bonds()
            params = None
            if param_set is not None:
                params = param_set.for_mol_type(self.ff_mol_type)
            if self.mol_specific_params is not None:
                params = merge_params(params, self.mol_specific_params) \
                    if params is not None else self.mol_specific_params
            s = mol.to_spec(params=params, ff_mol_type=self.ff_mol_type)
        s.static_ = self.static_
        s.bonded_only = self.bonded_only
        if self.atom_init_velocities is not None:
            s.velocities = np.asarray(self.atom_init_velocities)
        return s


def add_copies(spec: MolSpec, n_copies: int, box_extent,
               existing: Optional[np.ndarray] = None,
               min_sep: float = 3.0, seed: int = 0,
               max_rot_tries: int = 40) -> List[MolSpec]:
    """Grid/shell packing of N molecule copies with rotation search + clash
    checks (reference add_copies, src/md/mod.rs:341)."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(seed)
    box = np.asarray(box_extent, float)
    pos0 = np.asarray(spec.positions) - np.asarray(spec.positions).mean(0)
    n_grid = max(1, int(math.ceil(n_copies ** (1 / 3))))
    spacing = box / n_grid
    placed: List[MolSpec] = []
    occupied = [] if existing is None else [np.asarray(existing)]
    idx = 0
    for gi in range(n_grid):
        for gj in range(n_grid):
            for gk in range(n_grid):
                if idx >= n_copies:
                    break
                center = (np.array([gi, gj, gk]) + 0.5) * spacing
                ok_pos = None
                for _ in range(max_rot_tries):
                    q = rng.normal(size=4)
                    q /= np.linalg.norm(q)
                    w, xq, yq, zq = q
                    R = np.array([
                        [1 - 2 * (yq * yq + zq * zq), 2 * (xq * yq - w * zq), 2 * (xq * zq + w * yq)],
                        [2 * (xq * yq + w * zq), 1 - 2 * (xq * xq + zq * zq), 2 * (yq * zq - w * xq)],
                        [2 * (xq * zq - w * yq), 2 * (yq * zq + w * xq), 1 - 2 * (xq * xq + yq * yq)]])
                    cand = pos0 @ R.T + center
                    if not occupied:
                        ok_pos = cand
                        break
                    prev = np.concatenate(occupied)
                    d = cKDTree(prev).query(cand, k=1)[0]
                    if d.min() > min_sep:
                        ok_pos = cand
                        break
                if ok_pos is None:
                    ok_pos = cand   # accept the last try (relaxation fixes)
                m = copy.copy(spec)
                m.positions = ok_pos
                placed.append(m)
                occupied.append(ok_pos)
                idx += 1
    return placed


def build_dynamics(
    mols: Sequence[MolDynamics],
    cfg: MdConfig,
    param_set: Optional[FfParamSet] = None,
    external_forces_fn: Optional[Callable] = None,
    seed: int = 0,
    device=None,
) -> MdSim:
    """Assemble molecules (+ solvent per cfg) and construct the engine on
    `device` (None means the CUDA card; reference build_dynamics,
    src/md/mod.rs:641: param assignment, copies, solvation, relaxation).

    Three branches: vacuum (no solvent and a padded box: boxless,
    allpairs), a fixed box (cfg.sim_box.bounds; molecules shifted by its
    low corner, n_copies > 1 packed by add_copies), or a padded box around
    the solutes; then OPC, TIP3P or wet octanol fill the box. The MdSim
    takes cfg as given: a use_pallas config its method cannot run raises
    there.
    """
    param_set = param_set or FfParamSet.new_default()
    specs: List[MolSpec] = []
    for m in mols:
        s = m.to_spec(param_set)
        if m.n_copies > 1:
            if cfg.sim_box.kind != "fixed":
                raise ValueError("n_copies packing needs a fixed sim box")
            lo, hi = cfg.sim_box.bounds
            box = np.asarray(hi) - np.asarray(lo)
            specs.extend(add_copies(s, m.n_copies, box, seed=seed))
        else:
            specs.append(s)

    # box: a padded box only matters with solvent/periodicity; plain vacuum
    # runs (reference configs 1-2) are boxless
    if cfg.solvent.kind == "none" and cfg.sim_box.kind == "pad":
        return _finish_build(specs, None, cfg, None, None, seed,
                             external_forces_fn, device)
    if cfg.sim_box.kind == "fixed":
        lo, hi = np.asarray(cfg.sim_box.bounds[0]), np.asarray(
            cfg.sim_box.bounds[1])
        box = hi - lo
        for s in specs:
            s.positions = np.asarray(s.positions) - lo
    elif specs:
        allpos = np.concatenate([np.asarray(s.positions) for s in specs])
        extent = allpos.max(0) - allpos.min(0) + 2 * cfg.sim_box.pad
        box = extent
        shift = -allpos.min(0) + cfg.sim_box.pad
        for s in specs:
            s.positions = np.asarray(s.positions) + shift
    else:
        box = None

    # solvent
    wm = None
    n_w = None
    if cfg.solvent.kind in ("water_opc", "water_opc_mol_count"):
        wm = OPC
        n_w = cfg.solvent.mol_count
    elif cfg.solvent.kind == "water_tip3p":
        wm = TIP3P
    elif cfg.solvent.kind == "octanol_with_water":
        # wet octanol: grid-packed octanol molecules + water fill
        # (reference logp.rs:28-45; packer in systems/octanol.py)
        from ..systems.octanol import pack_octanol_box
        if box is None:
            box = np.array([30.0] * 3)
        oct_mols, n_w_oct = pack_octanol_box(
            float(np.min(box)),
            water_fraction=cfg.solvent.water_fraction, seed=seed)
        specs = specs + oct_mols
        wm = OPC
        n_w = n_w_oct
    return _finish_build(specs, box, cfg, wm, n_w, seed, external_forces_fn,
                         device)


def _finish_build(specs, box, cfg, wm, n_w, seed, external_forces_fn,
                  device):
    asys = assemble_system(
        specs, box_extent=box, water_model=wm, n_waters=n_w, seed=seed)
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent,
                external_forces_fn=external_forces_fn, device=device)
    sim.assembled = asys
    return sim


def run_dynamics_blocking(sim: MdSim, dt_ps: float, n_steps: int,
                          snapshot_interval: Optional[int] = None):
    """Run n_steps and return the snapshot list (reference
    run_dynamics_blocking, src/md/mod.rs:696)."""
    return sim.run(dt_ps, n_steps, snapshot_interval=snapshot_interval)


class MdHandle:
    """A run in a background thread (reference launch_md's handle): poll
    `running` and `step_count`, or `join` for the snapshots; an error in
    the run is raised by `join`. A sim on a numbered card (cuda:k) makes
    that card the thread's current device; the process's CUDA context is
    shared by its threads."""

    def __init__(self, sim: MdSim, dt_ps: float, n_steps: int,
                 snapshot_interval: Optional[int]):
        self.sim = sim
        self._err: Optional[BaseException] = None
        self._done = threading.Event()

        def work():
            try:
                if sim.device.type == "cuda" and sim.device.index is not None:
                    import torch
                    torch.cuda.set_device(sim.device)
                sim.run(dt_ps, n_steps, snapshot_interval=snapshot_interval)
            except BaseException as e:   # surfaced on join()
                self._err = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return not self._done.is_set()

    @property
    def step_count(self) -> int:
        return self.sim.step_count

    def join(self, timeout=None):
        self._thread.join(timeout)
        if self._err is not None:
            raise self._err
        return self.sim.snapshots


def launch_md(sim: MdSim, dt_ps: float, n_steps: int,
              snapshot_interval: Optional[int] = None) -> MdHandle:
    """Start a non-blocking run (reference launch_md, src/md/mod.rs:755)."""
    return MdHandle(sim, dt_ps, n_steps, snapshot_interval)
