"""Berendsen-style tau-coupled barostat (port of the finite-difference
path of molchanica_tpu.md.barostat, the one FastSim runs).

Instantaneous molecular pressure from the isotropic scaling derivative:

  P = (2 KE_com - dE/ds|_{s=1}) / (3 V),   E(s) = U(x + (s - 1) com, s box)

Each molecule's centre of mass moves with the box while its internal
geometry stays fixed, so constrained molecules (SETTLE waters, SHAKE
H-clusters) need no constraint virial, and the kinetic term is the
molecular translational one. `scaling_pressure_bar` takes dE/ds by
autograd through a differentiable energy; FastSim takes
`scaling_pressure_bar_fd`, a central difference, because the colpair
kernels have no gradient with respect to the box. The weak-coupling update
is applied once per rebuild period.
"""
from __future__ import annotations

import torch

from ..constants import ACCEL_FACTOR, PRESSURE_KCAL_PER_A3_TO_BAR
from .state import kinetic_energy


def _mol_com(x, masses, dof_mask, mol_id, n_mol):
    """(per-molecule centre of mass [n_mol, 3], mass [n_mol]) over the
    integrated sites (dof 1); virtual sites and pads (dof 0) add no mass
    but still ride along with their molecule's COM."""
    m_eff = masses * dof_mask
    msum = torch.zeros((n_mol,), dtype=x.dtype, device=x.device)
    msum = torch.clamp_min(msum.index_add(0, mol_id, m_eff), 1e-12)
    com = torch.zeros((n_mol, 3), dtype=x.dtype, device=x.device)
    com = com.index_add(0, mol_id, x * m_eff[:, None]) / msum[:, None]
    return com, msum


def scaling_pressure_bar(e_scalar_fn, x, box, v, masses, dof_mask, couple,
                         mol_id=None, n_mol=None):
    """Virial pressure (bar) from the exact scaling derivative, dE/ds by
    autograd: atomic scaling E(s x, s box) with the full kinetic energy,
    or with mol_id / n_mol the molecular (COM) scaling above."""
    vol = torch.prod(box)
    s = torch.ones((), dtype=x.dtype, device=x.device, requires_grad=True)
    with torch.enable_grad():
        if mol_id is None:
            ke = kinetic_energy(v, masses, dof_mask)
            e = e_scalar_fn(x * s, box * s, couple)
        else:
            com, msum = _mol_com(x, masses, dof_mask, mol_id, n_mol)
            vcom, _ = _mol_com(v, masses, dof_mask, mol_id, n_mol)
            ke = 0.5 * torch.sum(msum * torch.sum(vcom * vcom, dim=-1)) \
                / ACCEL_FACTOR
            e = e_scalar_fn(x + (s - 1.0) * com[mol_id], box * s, couple)
        (de_ds,) = torch.autograd.grad(e, s)
    p = (2.0 * ke - de_ds) / (3.0 * vol)
    return p * PRESSURE_KCAL_PER_A3_TO_BAR


def scaling_pressure_bar_fd(e_scalar_fn, x, box, v, masses, dof_mask,
                            couple, mol_id, n_mol, h=2e-3):
    """Molecular virial pressure (bar) with dE/ds ~ [E(1+h) - E(1-h)] / 2h.

    e_scalar_fn(x, box, couple) -> E. h = 2e-3 translates molecules by at
    most h L / 2 (~0.06 A at 60 A boxes), far inside the neighbour skin,
    so the window tables of the current period hold for both evaluations.
    The float32 energy puts ~10-50 bar of noise on one estimate at 25k
    sites; the Berendsen coupling (tau >> period) averages it out."""
    vol = torch.prod(box)
    com, msum = _mol_com(x, masses, dof_mask, mol_id, n_mol)
    vcom, _ = _mol_com(v, masses, dof_mask, mol_id, n_mol)
    ke = 0.5 * torch.sum(msum * torch.sum(vcom * vcom, dim=-1)) \
        / ACCEL_FACTOR
    ca = com[mol_id]
    ep = e_scalar_fn(x + h * ca, box * (1.0 + h), couple)
    em = e_scalar_fn(x - h * ca, box * (1.0 - h), couple)
    de_ds = (ep - em) / (2.0 * h)
    p = (2.0 * ke - de_ds) / (3.0 * vol)
    return p * PRESSURE_KCAL_PER_A3_TO_BAR


def berendsen_mu(p_bar, pressure_target_bar, tau_ps, dt_eff_ps,
                 compressibility_per_bar=4.5e-5):
    """Weak-coupling isotropic scale factor for a coupling interval dt_eff
    (the period's length when applied once per period); mu^3 clipped to
    [0.94, 1.06]."""
    mu3 = 1.0 - (dt_eff_ps / tau_ps) * compressibility_per_bar * (
        pressure_target_bar - p_bar)
    return torch.clamp(torch.as_tensor(mu3), 0.94, 1.06) ** (1.0 / 3.0)


def berendsen_scale_chunk(e_scalar_fn, x, box, v, masses, dof_mask, couple,
                          pressure_target_bar, tau_ps, dt_eff_ps,
                          compressibility_per_bar=4.5e-5,
                          mol_id=None, n_mol=None):
    """One barostat application: the exact pressure
    (`scaling_pressure_bar`), then x and the box scaled by mu. With mol_id
    / n_mol each molecule is translated by (mu - 1) COM instead, its
    internal geometry untouched, so constrained molecules stay on their
    manifold. Returns (x_new, box_new, p_bar)."""
    p = scaling_pressure_bar(e_scalar_fn, x, box, v, masses, dof_mask,
                             couple, mol_id=mol_id, n_mol=n_mol)
    mu = berendsen_mu(p, pressure_target_bar, tau_ps, dt_eff_ps,
                      compressibility_per_bar).to(x.dtype)
    if mol_id is None:
        x_new = x * mu
    else:
        com, _ = _mol_com(x, masses, dof_mask, mol_id, n_mol)
        x_new = x + (mu - 1.0) * com[mol_id]
    return x_new, box * mu, p
