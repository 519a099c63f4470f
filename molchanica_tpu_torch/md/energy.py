"""Potential-energy assembly with per-term breakdown (port of
molchanica_tpu.md.energy for MdSim's cell-grid path).

Only the "pme_rest" method is ported: everything except the direct-space
window sums, which come from the cell-grid kernel (ops/direct_force.py).
Forces are torch.autograd gradients of these energies.
"""
from __future__ import annotations

import math

import torch

from ..constants import COULOMB_CONST
from ..ops import nonbonded as nb
from ..ops.bonded import bonded_energy
from ..ops.direct_force import pairlist_kernel_formula_energy
from ..ops.pme import ewald_beta_for


def apply_virtual_sites(x, top):
    """Recompute the massless-site rows (OPC M) from their parent atoms,
    M = O + w ((H1 - O) + (H2 - O)). Padded vsite rows write into a sink
    row that is cut off, so no row is set twice and autograd sees each
    real M row once."""
    if top.vsite_idx is None:
        return x
    n = x.shape[0]
    m, o = top.vsite_idx[:, 0], top.vsite_idx[:, 1]
    h1, h2 = top.vsite_idx[:, 2], top.vsite_idx[:, 3]
    w = top.vsite_weight[:, None]
    xm = x[o] + w * ((x[h1] - x[o]) + (x[h2] - x[o]))
    sink = torch.full_like(m, n)
    xe = torch.cat([x, x[:1]])
    xe = xe.index_put((torch.where(top.vsite_mask > 0, m, sink),), xm)
    return xe[:n]


def _ewald_self_energy(top, couple, beta):
    """-beta/sqrt(pi) k sum q_eff^2; coupled atoms' charges scale with
    couple, so their self energy scales with couple^2."""
    q = top.charges * top.atom_mask
    q_eff = q * (1.0 - top.couple_mask * (1.0 - couple))
    return -beta / math.sqrt(math.pi) * COULOMB_CONST * torch.sum(
        q_eff * q_eff)


def make_energy_fn(top, cfg, method: str = "pme_rest", pme_recip_fn=None):
    """energy(x, box, couple) -> (E_total, terms) for method "pme_rest":
    reciprocal + self + erf exclusion correction, minus the kernel-formula
    contribution of excluded and 1-4 pairs (the cell-grid kernel adds every
    close pair), plus bonded and the scaled 1-4 terms."""
    if method != "pme_rest":
        raise NotImplementedError(
            f"energy method {method!r} is not ported (ROADMAP Queue 1 item "
            "7: the allpairs, allpairs_cutoff and cells_pme window "
            "backends)")
    ov = cfg.overrides
    scee = 1.0 / torch.clamp_min(top.pair14_scee, 1e-6)
    scnb = 1.0 / torch.clamp_min(top.pair14_scnb, 1e-6)
    if nb.intramol_pairs_np(top)[1].sum() > 0:
        raise NotImplementedError(
            "coupled atoms need intramol_recip_compensation (ROADMAP Queue "
            "1 item 4: dhdl / alchemical)")
    ewald_beta = ewald_beta_for(cfg.coulomb_cutoff, cfg.ewald_rtol)
    rc2 = max(cfg.lj_cutoff, cfg.coulomb_cutoff) ** 2

    def energy(x, box, couple):
        x = apply_virtual_sites(x, top)
        e_bonded, bterms = bonded_energy(x, box, top, ov)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        e_recip = zero
        e_self = zero
        el_x, ec_x = pairlist_kernel_formula_energy(
            x, box, top, top.excl_idx, top.excl_mask, couple, ewald_beta,
            rc2)
        el_4, ec_4 = pairlist_kernel_formula_energy(
            x, box, top, top.pair14_idx, top.pair14_mask, couple,
            ewald_beta, rc2)
        e_lj = -(el_x + el_4)
        e_c = -(ec_x + ec_4)
        if ov.lj_disabled:
            e_lj = torch.zeros_like(e_lj)
        if ov.coulomb_disabled:
            e_c = torch.zeros_like(e_c)
        if not (ov.long_range_recip_disabled or ov.coulomb_disabled):
            e_recip = pme_recip_fn(x, box, couple)
            e_self = _ewald_self_energy(top, couple, ewald_beta)
            e_c = e_c + nb.ewald_exclusion_correction(x, box, top, couple,
                                                      ewald_beta)
        # 1-4 scaled pairs: full (undamped) Coulomb at 1/scee, LJ at 1/scnb
        e14_lj, e14_c = nb.pairlist_energy(
            x, box, top, top.pair14_idx, top.pair14_mask,
            coulomb_scale=scee, lj_scale=scnb, couple_strength=couple)
        if ov.lj_disabled:
            e14_lj = torch.zeros_like(e14_lj)
        if ov.coulomb_disabled:
            e14_c = torch.zeros_like(e14_c)
        e_lj_t = e_lj + e14_lj
        e_c_t = e_c + e14_c + e_recip + e_self
        e_nb = e_lj_t + e_c_t
        total = e_bonded + e_nb
        terms = dict(bterms, lj=e_lj_t, coulomb=e_c_t, recip=e_recip,
                     energy_potential=total,
                     energy_potential_bonded=e_bonded,
                     energy_potential_nonbonded=e_nb,
                     cell_overflow=torch.zeros((), dtype=torch.int32,
                                               device=x.device))
        return total, terms

    return energy


def make_force_fn(energy_fn):
    """forces(x, box, couple) -> (F, (E, terms)), F = -dE/dx by autograd;
    the returned energies carry no graph."""
    def fwd(x, box, couple):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            e, terms = energy_fn(xg, box, couple)
            (g,) = torch.autograd.grad(e, xg)
        return -g, (e.detach(), {k: v.detach() for k, v in terms.items()})
    return fwd
