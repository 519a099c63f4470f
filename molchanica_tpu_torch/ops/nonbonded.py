"""Nonbonded pair energies: LJ (Beutler softcore) + Coulomb, dense all
pairs (vacuum and small boxes), over explicit pair lists, the Ewald
exclusion correction, and the coupled molecule's intramolecular pair list
with its reciprocal-space compensation (port of
molchanica_tpu.ops.nonbonded).

Pairs straddling the coupled molecule get softcore LJ and linearly scaled
Coulomb at coupling strength c (1 = fully coupled, reference lambda =
1 - c).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import COULOMB_CONST
from .pbc import displacement

SOFTCORE_ALPHA = 0.5

# Per-pair LJ energy clip (kcal/mol), shared with ops/direct_force.py.
LJ_CLIP = 1.0e7


def lorentz_berthelot(sig_i, sig_j, eps_i, eps_j):
    return 0.5 * (sig_i + sig_j), torch.sqrt(eps_i * eps_j)


def lj_energy(r2, sigma, eps):
    """Plain 12-6 LJ from the squared distance."""
    s2 = (sigma * sigma) / r2
    s6 = s2 * s2 * s2
    return 4.0 * eps * (s6 * s6 - s6)


def lj_softcore_energy(r2, sigma, eps, couple):
    """V = 4 eps c [(a(1-c) + (r/s)^6)^-2 - (a(1-c) + (r/s)^6)^-1]; plain
    LJ at c = 1. Written with s6/(a s6 + 1), finite at sigma = 0."""
    s2 = (sigma * sigma) / r2
    s6 = s2 * s2 * s2
    inv = s6 / (SOFTCORE_ALPHA * (1.0 - couple) * s6 + 1.0)
    return 4.0 * eps * couple * (inv * inv - inv)


def coulomb_energy(r, qq, ewald_beta=None):
    """k qq / r, or k qq erfc(beta r) / r under Ewald."""
    if ewald_beta is None:
        return COULOMB_CONST * qq / r
    return COULOMB_CONST * qq * torch.special.erfc(ewald_beta * r) / r


def switch_fn(r2, r_switch, r_cut):
    """Quintic potential switch on [r_switch, r_cut] from r^2."""
    t = (torch.sqrt(r2) - r_switch) / max(r_cut - r_switch, 1e-6)
    t = torch.clamp(t, 0.0, 1.0)
    return 1.0 - t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def pair_lj_coulomb(r2, qq, sigma, eps, couple, ewald_beta=None,
                    cutoff=None, lj_switch_start=None, lj_scale=1.0,
                    coulomb_scale=1.0, coulomb_cutoff=None):
    """Per-pair (E_lj, E_coul) from squared distance; callers apply their
    own validity masks."""
    r2 = torch.clamp_min(r2, 1e-4)
    r = torch.sqrt(r2)
    e_lj = torch.clamp(lj_softcore_energy(r2, sigma, eps, couple),
                       -LJ_CLIP, LJ_CLIP) * lj_scale
    e_c = coulomb_energy(r, qq, ewald_beta) * couple * coulomb_scale
    if cutoff is not None:
        in_range = r2 < cutoff * cutoff
        if lj_switch_start is not None:
            e_lj = e_lj * switch_fn(r2, lj_switch_start, cutoff)
        e_lj = torch.where(in_range, e_lj, torch.zeros_like(e_lj))
        rc_c = coulomb_cutoff if coulomb_cutoff is not None else cutoff
        e_c = torch.where(r2 < rc_c * rc_c, e_c, torch.zeros_like(e_c))
    return e_lj, e_c


def _pair_couple(top, i, j, couple_strength):
    cm = top.couple_mask
    is_alch = cm[i] + cm[j] - 2.0 * cm[i] * cm[j]
    return 1.0 - is_alch * (1.0 - couple_strength)


def _pair_mask_dense(n, atom_mask, excl_idx, excl_mask, pair14_idx,
                     pair14_mask):
    """[N, N] upper-triangle interaction mask with the excluded and 1-4
    pairs removed (both orders of each listed pair)."""
    mask = atom_mask[:, None] * atom_mask[None, :]
    mask = torch.triu(mask, diagonal=1)
    drop = torch.zeros((n, n), dtype=torch.bool, device=mask.device)
    for idx, m in ((excl_idx, excl_mask), (pair14_idx, pair14_mask)):
        i, j = idx[:, 0][m > 0], idx[:, 1][m > 0]
        drop[i, j] = True
        drop[j, i] = True
    return torch.where(drop, torch.zeros_like(mask), mask)


def allpairs_energy(x, box, top, couple_strength, ewald_beta=None,
                    cutoff=None, lj_switch_start=None, lj_enabled=True,
                    coulomb_enabled=True):
    """Dense N x N (E_lj, E_coul), minimum image when `box` is given; for
    vacuum systems and small boxes."""
    n = x.shape[0]
    dx = displacement(x[:, None, :], x[None, :, :], box)
    r2 = torch.sum(dx * dx, dim=-1)
    sig, eps = lorentz_berthelot(top.lj_sigma[:, None], top.lj_sigma[None, :],
                                 top.lj_eps[:, None], top.lj_eps[None, :])
    qq = top.charges[:, None] * top.charges[None, :]
    cm = top.couple_mask
    is_alch = cm[:, None] + cm[None, :] - 2.0 * cm[:, None] * cm[None, :]
    couple = 1.0 - is_alch * (1.0 - couple_strength)
    mask = _pair_mask_dense(n, top.atom_mask, top.excl_idx, top.excl_mask,
                            top.pair14_idx, top.pair14_mask)
    e_lj, e_c = pair_lj_coulomb(r2, qq, sig, eps, couple, ewald_beta, cutoff,
                                lj_switch_start)
    if not lj_enabled:
        e_lj = torch.zeros_like(e_lj)
    if not coulomb_enabled:
        e_c = torch.zeros_like(e_c)
    return torch.sum(e_lj * mask), torch.sum(e_c * mask)


def pairlist_energy(x, box, top, idx, mask, coulomb_scale, lj_scale,
                    couple_strength, ewald_beta=None):
    """(E_lj, E_coul) over an explicit pair list (1-4 terms, corrections);
    the scales are per-pair multipliers (e.g. 1/scee, 1/scnb)."""
    i, j = idx[:, 0], idx[:, 1]
    dx = displacement(x[i], x[j], box)
    r2 = torch.clamp_min(torch.sum(dx * dx, dim=-1), 1e-4)
    sig, eps = lorentz_berthelot(top.lj_sigma[i], top.lj_sigma[j],
                                 top.lj_eps[i], top.lj_eps[j])
    qq = top.charges[i] * top.charges[j]
    e_lj, e_c = pair_lj_coulomb(
        r2, qq, sig, eps, _pair_couple(top, i, j, couple_strength),
        ewald_beta=ewald_beta, lj_scale=lj_scale,
        coulomb_scale=coulomb_scale)
    return torch.sum(e_lj * mask), torch.sum(e_c * mask)


def ewald_exclusion_correction(x, box, top, couple_strength, ewald_beta):
    """-k qq erf(beta r)/r over excluded and 1-4 pairs: the reciprocal sum
    holds every pair, so these lose its smooth part again. The alchemical
    factor is the product of the per-atom charge scalings, as the
    reciprocal sum applied it."""
    cm = top.couple_mask

    def erf_part(idx, mask):
        i, j = idx[:, 0], idx[:, 1]
        dx = displacement(x[i], x[j], box)
        r = torch.sqrt(torch.clamp_min(torch.sum(dx * dx, dim=-1), 1e-4))
        qq = top.charges[i] * top.charges[j]
        couple = (1.0 - cm[i] * (1.0 - couple_strength)) \
            * (1.0 - cm[j] * (1.0 - couple_strength))
        e = COULOMB_CONST * qq * couple * torch.erf(ewald_beta * r) / r
        return torch.sum(e * mask)

    return -(erf_part(top.excl_idx, top.excl_mask)
             + erf_part(top.pair14_idx, top.pair14_mask))


def intramol_pairs_np(top, max_coupled: int = 2048):
    """Non-excluded, non-1-4 pairs internal to the coupled molecule, as
    (int32 [P, 2], float32 mask [P]); P >= 1, padded with (0, 0) mask 0.

    They appear in the PME reciprocal sum with couple^2-scaled charges but
    stay at full strength at every lambda (GROMACS couple-intramol=no)."""
    def a(t):
        return t.detach().cpu().numpy()

    cm = a(top.couple_mask) * a(top.atom_mask)
    coupled = np.where(cm > 0)[0]
    empty = (np.zeros((1, 2), np.int32), np.zeros((1,), np.float32))
    if coupled.size == 0:
        return empty
    if coupled.size > max_coupled:
        raise ValueError(
            f"coupled molecule too large ({coupled.size} atoms) for the "
            "intramolecular compensation pair list")
    skip = set()
    for idx, m in ((a(top.excl_idx), a(top.excl_mask)),
                   (a(top.pair14_idx), a(top.pair14_mask))):
        for (i, j), mm in zip(idx, m):
            if mm > 0:
                skip.add((min(int(i), int(j)), max(int(i), int(j))))
    pairs = [(int(coupled[p]), int(coupled[q]))
             for p in range(coupled.size)
             for q in range(p + 1, coupled.size)
             if (int(coupled[p]), int(coupled[q])) not in skip]
    if not pairs:
        return empty
    return (np.asarray(pairs, np.int32), np.ones((len(pairs),), np.float32))


def intramol_recip_compensation(x, box, top, idx, mask, couple_strength,
                                ewald_beta):
    """+k qq erf(beta r)/r (1 - c^2) over the coupled molecule's
    intramolecular non-excluded pairs: direct space keeps them at full
    strength, the reciprocal sum scaled them by c^2."""
    i, j = idx[:, 0], idx[:, 1]
    dx = displacement(x[i], x[j], box)
    r = torch.sqrt(torch.clamp_min(torch.sum(dx * dx, dim=-1), 1e-4))
    qq = top.charges[i] * top.charges[j]
    c2 = couple_strength * couple_strength
    e = COULOMB_CONST * qq * torch.erf(ewald_beta * r) / r * (1.0 - c2)
    return torch.sum(e * mask)
