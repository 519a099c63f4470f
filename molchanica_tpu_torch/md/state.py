"""MdSim's dynamic state, kinetic energy, temperature, Maxwell-Boltzmann
velocities and COM-drift removal (port of molchanica_tpu.md.state)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from ..constants import ACCEL_FACTOR, KB


@dataclass
class MdState:
    """What changes during an MdSim run. Tensors are replaced, never
    updated in place, so an old state stays a valid restore point. The
    generator takes the place of the reference's rng_key."""
    positions: torch.Tensor      # [N, 3] A
    velocities: torch.Tensor     # [N, 3] A/ps
    box: Optional[torch.Tensor]  # [3] extents, None for vacuum
    step: int
    generator: torch.Generator
    couple: torch.Tensor         # coupling strength (1 = fully coupled);
                                 # reference lambda = 1 - couple
    pe_last: torch.Tensor        # potential energy of the last force
    ke_last: torch.Tensor        # kinetic energy after the last step
    dhdl_last: torch.Tensor      # dH/dlambda at the last finalize

    @property
    def n_atoms(self) -> int:
        return self.positions.shape[0]

    def replace(self, **kw) -> "MdState":
        return dataclasses.replace(self, **kw)


def kinetic_energy(velocities, masses, dof_mask):
    """0.5 m v^2 over integrated dofs, in kcal/mol (per replica, [R], for
    velocities [R, N, 3])."""
    ke = 0.5 * torch.sum(masses * dof_mask
                         * torch.sum(velocities ** 2, dim=-1), dim=-1)
    return ke / ACCEL_FACTOR


def instantaneous_temperature(velocities, masses, dof_mask, n_constraints=0):
    """2 KE / (kB ndof), ndof = 3 N_dof - n_constraints - 3 (COM removed)."""
    ndof = 3.0 * torch.sum(dof_mask) - n_constraints - 3.0
    ke = kinetic_energy(velocities, masses, dof_mask)
    return 2.0 * ke / (KB * torch.clamp_min(ndof, 1.0))


def init_velocities(generator: torch.Generator, masses, dof_mask, temp):
    """Maxwell-Boltzmann draw at `temp` K from `generator`, COM motion
    removed. sigma_v = sqrt(kB T ACCEL_FACTOR / m) in A/ps."""
    sigma = torch.sqrt(KB * temp * ACCEL_FACTOR
                       / torch.clamp_min(masses, 1e-6))
    v = torch.randn((masses.shape[0], 3), generator=generator,
                    dtype=masses.dtype, device=masses.device)
    v = v * sigma[:, None] * dof_mask[:, None]
    return remove_com_drift(v, masses, dof_mask)


def remove_com_drift(velocities, masses, dof_mask):
    """Zero the total linear momentum."""
    m = masses * dof_mask
    p = torch.sum(velocities * m[:, None], dim=0)
    return velocities - (p / torch.clamp_min(torch.sum(m), 1e-6)) \
        * dof_mask[:, None]
