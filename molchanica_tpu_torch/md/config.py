"""Run configuration (copy of molchanica_tpu.md.config without its TPU-only
knobs and JSON persistence): `MdConfig`, `Integrator`, `HydrogenConstraint`
and the nested configs it references. Host-side dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

from ..constants import (
    LANGEVIN_GAMMA_DEFAULT,
    LINCS_ITER_DEFAULT,
    LINCS_ORDER_DEFAULT,
    PRESSURE_DEFAULT,
    SHAKE_TOL_DEFAULT,
    TAU_PRESSURE_DEFAULT,
    TAU_TEMP_DEFAULT,
    TEMP_TARGET_DEFAULT,
)


# --- Integrators ---
@dataclass(frozen=True)
class Integrator:
    kind: str = "verlet_velocity"   # "leapfrog" | "verlet_velocity" | "langevin_middle"
    thermostat_tau: Optional[float] = TAU_TEMP_DEFAULT  # CSVR tau (ps); None = NVE
    gamma: float = LANGEVIN_GAMMA_DEFAULT               # Langevin friction 1/ps
    # Constraint cadence for langevin_middle (rigid water / H clusters):
    #   "light"  — the OpenMM LangevinMiddle schedule: one velocity
    #              projection after the kick, one position projection (with
    #              velocity feedback) after the last half-drift. The
    #              production default and the industry-standard cadence
    #              for rigid-water MD.
    #   "strict" — g-BAOAB: projection after EVERY substep (2 position +
    #              3 velocity per step). Reference-quality for constraint
    #              statistics studies.
    cadence: str = "light"

    @staticmethod
    def leapfrog(thermostat: Optional[float] = TAU_TEMP_DEFAULT):
        return Integrator("leapfrog", thermostat_tau=thermostat)

    @staticmethod
    def verlet_velocity(thermostat: Optional[float] = TAU_TEMP_DEFAULT):
        return Integrator("verlet_velocity", thermostat_tau=thermostat)

    @staticmethod
    def langevin_middle(gamma: float = LANGEVIN_GAMMA_DEFAULT,
                        cadence: str = "light"):
        return Integrator("langevin_middle", thermostat_tau=None,
                          gamma=gamma, cadence=cadence)


# --- H constraints ---
@dataclass(frozen=True)
class HydrogenConstraint:
    kind: str = "shake"   # "linear" (LINCS-like) | "shake" | "flexible"
    order: int = LINCS_ORDER_DEFAULT
    iters: int = LINCS_ITER_DEFAULT
    shake_tolerance: float = SHAKE_TOL_DEFAULT
    shake_max_iters: int = 25

    @staticmethod
    def linear(order: int = LINCS_ORDER_DEFAULT, iters: int = LINCS_ITER_DEFAULT):
        return HydrogenConstraint("linear", order=order, iters=iters)

    @staticmethod
    def shake(tol: float = SHAKE_TOL_DEFAULT):
        return HydrogenConstraint("shake", shake_tolerance=tol)

    @staticmethod
    def flexible():
        return HydrogenConstraint("flexible")


# --- Solvent ---
@dataclass(frozen=True)
class Solvent:
    kind: str = "none"   # none | water_opc | water_opc_mol_count | water_tip3p | octanol_with_water
    mol_count: Optional[int] = None
    water_fraction: float = 0.27  # octanol mix: 27 mol% water

    @staticmethod
    def none():
        return Solvent("none")

    @staticmethod
    def water_opc():
        return Solvent("water_opc")

    @staticmethod
    def water_opc_specify_mol_count(n: int):
        return Solvent("water_opc_mol_count", mol_count=n)

    @staticmethod
    def water_tip3p():
        return Solvent("water_tip3p")

    @staticmethod
    def octanol_with_water(water_fraction: float = 0.27):
        return Solvent("octanol_with_water", water_fraction=water_fraction)


# --- Simulation box init ---
@dataclass(frozen=True)
class SimBoxInit:
    kind: str = "pad"     # "pad" | "fixed"
    pad: float = 10.0     # A of padding around solute
    bounds: Optional[Tuple[Tuple[float, float, float], Tuple[float, float, float]]] = None

    @staticmethod
    def pad_(p: float):
        return SimBoxInit("pad", pad=p)

    @staticmethod
    def fixed(lo, hi):
        return SimBoxInit("fixed", bounds=(tuple(lo), tuple(hi)))

    @staticmethod
    def new_cube(side: float):
        h = side / 2.0
        return SimBoxInit.fixed((-h, -h, -h), (h, h, h))


@dataclass(frozen=True)
class BarostatCfg:
    """Berendsen-style tau-coupled barostat."""
    pressure_target: float = PRESSURE_DEFAULT   # bar
    tau: float = TAU_PRESSURE_DEFAULT           # ps


@dataclass(frozen=True)
class MdOverrides:
    """Per-term ablation switches — first-class
    config for validating individual physical processes."""
    skip_water: bool = False
    skip_water_relaxation: bool = False
    bonded_disabled: bool = False
    coulomb_disabled: bool = False
    lj_disabled: bool = False
    long_range_recip_disabled: bool = False
    snapshots_during_equilibration: bool = False


@dataclass(frozen=True)
class OutputControl:
    """GROMACS-style output cadence."""
    nstxout: int = 0
    nstvout: int = 0
    nstfout: int = 0
    nstenergy: int = 100
    nstcalcenergy: int = 100
    nstxout_compressed: int = 0


@dataclass(frozen=True)
class SnapshotHandlers:
    """Where snapshots go."""
    memory: Optional[int] = 100           # interval in steps, None = off
    dcd: Optional[str] = None             # path
    gromacs: OutputControl = field(default_factory=OutputControl)


@dataclass(frozen=True)
class MdConfig:
    """Full run configuration."""
    integrator: Integrator = field(default_factory=Integrator)
    temp_target: float = TEMP_TARGET_DEFAULT
    barostat_cfg: Optional[BarostatCfg] = None
    sim_box: SimBoxInit = field(default_factory=lambda: SimBoxInit("pad", pad=10.0))
    solvent: Solvent = field(default_factory=Solvent.none)
    hydrogen_constraint: HydrogenConstraint = field(default_factory=HydrogenConstraint)
    coulomb_cutoff: float = 9.0       # A (direct-space Ewald cutoff)
    lj_cutoff: float = 9.0            # A
    lj_switch_start: Optional[float] = None  # None => plain truncation
    zero_com_drift: bool = True
    max_init_relaxation_iters: Optional[int] = 200
    recenter_sim_box: bool = False
    snapshot_handlers: SnapshotHandlers = field(default_factory=SnapshotHandlers)
    overrides: MdOverrides = field(default_factory=MdOverrides)
    # --- engine settings ---
    dtype: str = "float32"
    steps_per_chunk: int = 100        # reference scan-chunk length (unused
                                      # by the port's host loop)
    neighbor_rebuild_every: int = 20  # steps between re-sorts
    pme_grid: Optional[Tuple[int, int, int]] = None  # None = auto from box
    pme_order: int = 4                # the .mdp's pme-order (io/gromacs.py);
                                      # the port's PME has its own orders
    ewald_rtol: float = 1e-5          # erfc(beta*rc) target at the cutoff
    cell_capacity_factor: float = 1.7 # reference knob; the cell-grid plan
                                      # sets capacity from occupancy
    # MdSim's direct space: the cell-grid kernel (ops/direct_force.py) when
    # True, else the cluster-pair backend ("auto") or the dense window
    use_pallas: bool = False
    direct_backend: str = "auto"
    # torch.profiler output directory: FastSim.run traces its steps and
    # writes a Chrome trace there when set
    trace_dir: Optional[str] = None
    seed: int = 0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)
