"""Bonded (valence) energies: bonds, angles, proper/improper dihedrals
(port of molchanica_tpu.ops.bonded).

Pure functions of positions; forces come from torch.autograd. Padded rows
carry zero force constants, so they add zero energy and zero gradient.
"""
from __future__ import annotations

import torch

from .pbc import displacement


def _safe_norm(v, eps=1e-12):
    """Norm over the last axis with a gradient that is finite at 0."""
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), eps))


def _unit(like, axis):
    e = torch.zeros_like(like)
    e[:, axis] = 1.0
    return e


def bond_energy(x, box, idx, k, r0):
    """Sum_b k_b (|ri-rj| - r0_b)^2."""
    r = _safe_norm(displacement(x[idx[:, 0]], x[idx[:, 1]], box))
    dr = r - r0
    return torch.sum(k * dr * dr)


def angle_energy(x, box, idx, k, theta0):
    """Sum_a k_a (theta - theta0)^2 with theta the i-j-k angle at j."""
    rj = x[idx[:, 1]]
    v1 = displacement(x[idx[:, 0]], rj, box)
    v2 = displacement(x[idx[:, 2]], rj, box)
    # padded rows (k == 0, coincident atoms) get unit vectors so their
    # zero-weighted gradient stays finite
    m = (k > 0)[:, None]
    v1 = torch.where(m, v1, _unit(v1, 0))
    v2 = torch.where(m, v2, _unit(v2, 1))
    # atan2 form: stable gradient at theta ~ 0 and pi
    sin_t = _safe_norm(torch.linalg.cross(v1, v2, dim=-1))
    cos_t = torch.sum(v1 * v2, dim=-1)
    dt = torch.atan2(sin_t, cos_t) - theta0
    return torch.sum(k * dt * dt)


def dihedral_angle(x, box, idx, valid=None):
    """Signed dihedral phi for rows (i, j, k, l), IUPAC sign convention."""
    b1 = displacement(x[idx[:, 1]], x[idx[:, 0]], box)
    b2 = displacement(x[idx[:, 2]], x[idx[:, 1]], box)
    b3 = displacement(x[idx[:, 3]], x[idx[:, 2]], box)
    if valid is not None:
        m = valid[:, None]
        b1 = torch.where(m, b1, _unit(b1, 0))
        b2 = torch.where(m, b2, _unit(b2, 1))
        b3 = torch.where(m, b3, _unit(b3, 2))
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / _safe_norm(b2)[..., None]
    m1 = torch.linalg.cross(n1, b2n, dim=-1)
    xc = torch.sum(n1 * n2, dim=-1)
    yc = torch.sum(m1 * n2, dim=-1)
    return torch.atan2(yc, xc)


def dihedral_energy(x, box, idx, k, n, phase):
    """Sum_d k_d (1 + cos(n_d phi - phase_d))."""
    phi = dihedral_angle(x, box, idx, valid=(k != 0))
    return torch.sum(k * (1.0 + torch.cos(n * phi - phase)))
