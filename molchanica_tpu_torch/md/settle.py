"""Analytic SETTLE for rigid 3-site water and its RATTLE velocity
projection, on the blocked layout (port of the rolled path of
molchanica_tpu.md.settle).

In FastSim's sorted state every water occupies consecutive slots
(O, H1, H2[, M]). Site peers are reached by torch.roll: every slot runs
the math as if it were an O and the mask keeps only the O rows.
SETTLE: Miyamoto & Kollman, J Comput Chem 13:952 (1992).
"""
from __future__ import annotations

import math

import torch

from ..ops.pbc import minimum_image


def settle_params(r_oh: float, theta_hoh: float, m_o: float, m_h: float):
    """(ra, rb, rc): O at (0, ra), H at (+-rc, -rb) in the molecular plane
    with the center of mass at the origin."""
    half = 0.5 * theta_hoh
    rc = r_oh * math.sin(half)          # half H-H distance
    d_ohh = r_oh * math.cos(half)       # O to HH midpoint
    m_tot = m_o + 2.0 * m_h
    ra = 2.0 * m_h * d_ohh / m_tot
    rb = d_ohh - ra
    return float(ra), float(rb), float(rc)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _normalize(v):
    return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True),
                               1e-12)


def _settle_core(o0, h10, h20, o1, h11, h21, ra, rb, rc, m_o, m_h):
    """Miyamoto-Kollman math on anchor-relative site arrays (o0 = 0).
    Returns the anchor-relative constrained (o, h1, h2)."""
    m_tot = m_o + 2.0 * m_h
    com1 = (m_o * o1 + m_h * (h11 + h21)) / m_tot

    # axes from the OLD triangle; z' normal to the old plane
    zax = _normalize(torch.linalg.cross(h10 - o0, h20 - o0, dim=-1))
    a1 = o1 - com1
    b1 = h11 - com1
    c1 = h21 - com1
    a1z = torch.sum(a1 * zax, dim=-1, keepdim=True)
    xax = _normalize(a1 - a1z * zax)
    yax = torch.linalg.cross(zax, xax, dim=-1)

    def comp(v):
        return _dot(v, xax), _dot(v, yax), _dot(v, zax)

    _a1x, _a1y, a1z_ = comp(a1)
    b1x, b1y, b1z = comp(b1)
    c1x, c1y, c1z = comp(c1)

    sinphi = torch.clamp(a1z_ / ra, -1.0, 1.0)
    cosphi = torch.sqrt(torch.clamp_min(1.0 - sinphi * sinphi, 1e-12))
    sinpsi = torch.clamp((b1z - c1z) / (2.0 * rc * cosphi), -1.0, 1.0)
    cospsi = torch.sqrt(torch.clamp_min(1.0 - sinpsi * sinpsi, 1e-12))

    a2y = ra * cosphi
    a2z = ra * sinphi
    b2x = -rc * cospsi
    b2y = -rb * cosphi - rc * sinpsi * sinphi
    b2z = -rb * sinphi + rc * sinpsi * cosphi
    c2x = rc * cospsi
    c2y = -rb * cosphi + rc * sinpsi * sinphi
    c2z = -rb * sinphi - rc * sinpsi * cosphi

    # the exact in-plane rotation: alpha sin(th) + beta cos(th) = gamma from
    # the OLD positions about the OLD center of mass (symplectic)
    com0 = (m_o * o0 + m_h * (h10 + h20)) / m_tot
    b0x, b0y, _ = comp(h10 - com0)
    c0x, c0y, _ = comp(h20 - com0)
    alpha = b2x * (b0x - c0x) + b0y * b2y + c0y * c2y
    beta = b2x * (c0y - b0y) + b0x * b2y + c0x * c2y
    gamma = b0x * b1y - b1x * b0y + c0x * c1y - c1x * c0y
    al2be2 = torch.clamp_min(alpha * alpha + beta * beta, 1e-24)
    under = torch.clamp_min(al2be2 - gamma * gamma, 0.0)
    sinth = torch.clamp((alpha * gamma - beta * torch.sqrt(under)) / al2be2,
                        -1.0, 1.0)
    # cos(theta) from the constraint equation (keeps its sign)
    cos_mag = torch.sqrt(torch.clamp_min(1.0 - sinth * sinth, 1e-24))
    big = torch.abs(beta) > 1e-9
    costh = torch.where(
        big, (gamma - alpha * sinth)
        / torch.where(big, beta, torch.ones_like(beta)), cos_mag)
    nrm = torch.sqrt(torch.clamp_min(sinth * sinth + costh * costh, 1e-24))
    sinth = sinth / nrm
    costh = costh / nrm

    def back(px, py, pz):
        rx = px * costh - py * sinth
        ry = px * sinth + py * costh
        return (rx[..., None] * xax + ry[..., None] * yax
                + pz[..., None] * zax + com1)

    return (back(torch.zeros_like(a2y), a2y, a2z),
            back(b2x, b2y, b2z), back(c2x, c2y, c2z))


def _scatter_back(m, base, o, h1, h2):
    """Blocked-layout merge: O rows from `o`, the next two slots from
    `h1`/`h2` of their O, everything else from `base`."""
    m = m[:, None]
    out = torch.where(m, o, base)
    out = torch.where(torch.roll(m, 1, 0), torch.roll(h1, 1, 0), out)
    return torch.where(torch.roll(m, 2, 0), torch.roll(h2, 2, 0), out)


def settle_compute_rolled(x_new, x_old, m_o_mask, ra, rb, rc, m_o, m_h,
                          box=None):
    """x_new/x_old: sorted [S, 3] with blocked waters; m_o_mask [S] marks
    the O slots. Returns the merged constrained positions."""
    r1 = lambda a: torch.roll(a, -1, 0)
    r2 = lambda a: torch.roll(a, -2, 0)
    anchor = x_old
    o_r, h1_r, h2_r = _settle_core(
        torch.zeros_like(anchor),
        minimum_image(r1(x_old) - anchor, box),
        minimum_image(r2(x_old) - anchor, box),
        minimum_image(x_new - anchor, box),
        minimum_image(r1(x_new) - anchor, box),
        minimum_image(r2(x_new) - anchor, box),
        ra, rb, rc, m_o, m_h)

    # re-express each output in its own atom's stored image, so the
    # velocity feedback never sees a box-sized jump
    def rerep(val_rel, cur):
        return cur + minimum_image(val_rel + anchor - cur, box)

    return _scatter_back(m_o_mask, x_new, rerep(o_r, x_new),
                         rerep(h1_r, r1(x_new)), rerep(h2_r, r2(x_new)))


def _settle_vel_core(h1, h2, vo, vh1, vh2, m_o, m_h):
    """RATTLE projection for one water's three constraints (analytic 3x3
    solve). Positions are O-relative; returns (dvo, dvh1, dvh2)."""
    eab = -h1
    eac = -h2
    ebc = h1 - h2
    vab = _dot(eab, vo - vh1)
    vac = _dot(eac, vo - vh2)
    vbc = _dot(ebc, vh1 - vh2)
    io, ih = 1.0 / m_o, 1.0 / m_h

    a11 = (io + ih) * _dot(eab, eab)
    a12 = io * _dot(eab, eac)
    a13 = -ih * _dot(eab, ebc)
    a22 = (io + ih) * _dot(eac, eac)
    a23 = ih * _dot(eac, ebc)
    a33 = 2.0 * ih * _dot(ebc, ebc)
    a21, a31, a32 = a12, a13, a23

    b1, b2, b3 = -vab, -vac, -vbc
    c00 = a22 * a33 - a23 * a32
    c01 = a13 * a32 - a12 * a33
    c02 = a12 * a23 - a13 * a22
    det = a11 * c00 + a21 * c01 + a31 * c02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-12,
                                torch.full_like(det, 1e-12), det)
    l1 = (b1 * c00 + b2 * c01 + b3 * c02) * inv_det
    l2 = (b1 * (a23 * a31 - a21 * a33) + b2 * (a11 * a33 - a13 * a31)
          + b3 * (a13 * a21 - a11 * a23)) * inv_det
    l3 = (b1 * (a21 * a32 - a22 * a31) + b2 * (a12 * a31 - a11 * a32)
          + b3 * (a11 * a22 - a12 * a21)) * inv_det

    dvo = io * (l1[..., None] * eab + l2[..., None] * eac)
    dvh1 = ih * (-l1[..., None] * eab + l3[..., None] * ebc)
    dvh2 = ih * (-l2[..., None] * eac - l3[..., None] * ebc)
    return dvo, dvh1, dvh2


def settle_velocities_rolled(v, x, m_o_mask, m_o, m_h, box=None):
    """Blocked-layout velocity projection; returns the projected v."""
    r1 = lambda a: torch.roll(a, -1, 0)
    r2 = lambda a: torch.roll(a, -2, 0)
    dvo, dvh1, dvh2 = _settle_vel_core(
        minimum_image(r1(x) - x, box), minimum_image(r2(x) - x, box),
        v, r1(v), r2(v), m_o, m_h)
    zero = torch.zeros_like(v)
    m = m_o_mask[:, None]
    dv = torch.where(m, dvo, zero)
    dv = dv + torch.where(torch.roll(m, 1, 0), torch.roll(dvh1, 1, 0), zero)
    dv = dv + torch.where(torch.roll(m, 2, 0), torch.roll(dvh2, 2, 0), zero)
    return v + dv
