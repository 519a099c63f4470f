"""Kinetic energy, Maxwell-Boltzmann velocities and COM-drift removal
(port of the functions of molchanica_tpu.md.state)."""
from __future__ import annotations

import torch

from ..constants import ACCEL_FACTOR, KB


def kinetic_energy(velocities, masses, dof_mask):
    """0.5 m v^2 over integrated dofs, in kcal/mol."""
    ke = 0.5 * torch.sum(masses * dof_mask
                         * torch.sum(velocities ** 2, dim=-1))
    return ke / ACCEL_FACTOR


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
