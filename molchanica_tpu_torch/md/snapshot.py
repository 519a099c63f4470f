"""Snapshot: host-side trajectory frames (port of molchanica_tpu.md.snapshot).

The reference layout: time, atom positions, water optionally stored as
separate O/H0/H1 arrays, the per-frame energy triple (potential /
nonbonded / bonded), and a hydrogen-bond slot for later analysis.
"""
from __future__ import annotations

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
    atom_posits: np.ndarray          # [n_atoms, 3]
    water_o_posits: Optional[np.ndarray] = None
    water_h0_posits: Optional[np.ndarray] = None
    water_h1_posits: Optional[np.ndarray] = None
    energy_data: Optional[EnergyData] = None
    hydrogen_bonds: list = field(default_factory=list)
    dhdl: Optional[float] = None     # alchemical dH/dlambda at this frame
    kinetic_energy: Optional[float] = None
    box_extent: Optional[np.ndarray] = None
