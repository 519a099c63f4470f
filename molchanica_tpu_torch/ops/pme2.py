"""SPME reciprocal space at order 4 with matmul spreading (port of
molchanica_tpu.ops.pme2).

The charge mesh is reached through dense one-hot products instead of a
scatter:

    Q[gx, gy, gz] = sum_a (q_a Wx[a, gx]) Wy[a, gy] Wz[a, gz]
                  = (q * Wx)^T (Wy (x) Wz)            per chunk of atoms

with Wx, Wy, Wz the dense per-axis order-4 B-spline weight matrices (4
nonzeros per row). The energy is differentiable in x and q_eff through
autograd (the backward of the products is the SPME interpolation).
Energy convention as ops/pme3.py: tin-foil boundary, k = 0 dropped,
net-charge background correction.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import COULOMB_CONST
from ..device import resolve_device
from .pme3 import _bspline_b2_n


def bspline4_weights(t):
    """Order-4 cardinal B-spline weights M4(t + k), k = 0..3, t in [0, 1):
    the contributions to grid points floor(u), floor(u) - 1, - 2, - 3."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([t3 / 6.0,
                        (-3.0 * t3 + 3.0 * t2 + 3.0 * t + 1.0) / 6.0,
                        (3.0 * t3 - 6.0 * t2 + 4.0) / 6.0,
                        (1.0 - t) ** 3 / 6.0], dim=-1)


def _axis_weights(u, K):
    """Dense [A, K] spreading matrix of one axis from fractional coords."""
    u0 = torch.floor(u)
    w = bspline4_weights(u - u0)                                  # [A, 4]
    offs = torch.arange(4, device=u.device)
    idx = torch.remainder(u0.long()[:, None] - offs[None, :], K)  # [A, 4]
    grid = torch.arange(K, device=u.device)
    onehot = idx[:, :, None] == grid[None, None, :]
    return torch.where(onehot, w[:, :, None],
                       torch.zeros((), dtype=u.dtype, device=u.device)).sum(1)


def make_pme2_recip_fn(grid_shape, beta, dtype=torch.float32, chunk=2048,
                       device=None):
    """recip(x, q_eff, box) -> E_recip, differentiable in x and q_eff. The
    mesh is fixed at build; the influence function tracks the live box.
    Its constants live on `device` (None means the CUDA card)."""
    dev = resolve_device(device)
    Kx, Ky, Kz = (int(k) for k in grid_shape)
    b2 = (_bspline_b2_n(Kx, 4)[:, None, None]
          * _bspline_b2_n(Ky, 4)[None, :, None]
          * _bspline_b2_n(Kz, 4)[None, None, :])
    kw = dict(dtype=dtype, device=dev)
    b2 = torch.as_tensor(b2, **kw)
    mx, my, mz = (torch.as_tensor(np.fft.fftfreq(k) * k, **kw)
                  for k in (Kx, Ky, Kz))
    Ks = torch.tensor([Kx, Ky, Kz], **kw)
    beta = float(beta)

    def spread(x, q_eff, box):
        u = x / box * Ks
        Q = torch.zeros((Kx, Ky * Kz), dtype=x.dtype, device=x.device)
        for a0 in range(0, x.shape[0], chunk):
            us = u[a0:a0 + chunk]
            wx = _axis_weights(us[:, 0], Kx) * q_eff[a0:a0 + chunk, None]
            wy = _axis_weights(us[:, 1], Ky)
            wz = _axis_weights(us[:, 2], Kz)
            P = (wy[:, :, None] * wz[:, None, :]).reshape(-1, Ky * Kz)
            Q = Q + wx.T @ P
        return Q.reshape(Kx, Ky, Kz)

    def recip(x, q_eff, box):
        S = torch.fft.fftn(spread(x, q_eff, box))
        kx = 2.0 * math.pi * mx / box[0]
        ky = 2.0 * math.pi * my / box[1]
        kz = 2.0 * math.pi * mz / box[2]
        k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
              + kz[None, None, :] ** 2)
        k2_safe = torch.where(k2 == 0.0, torch.ones_like(k2), k2)
        vol = box[0] * box[1] * box[2]
        infl = 4.0 * math.pi / k2_safe * torch.exp(
            -k2_safe / (4.0 * beta * beta))
        infl = torch.where(k2 == 0.0, torch.zeros_like(infl), infl) * b2
        e = (COULOMB_CONST / (2.0 * vol)) * torch.sum(
            infl * (S.real ** 2 + S.imag ** 2))
        qtot = torch.sum(q_eff)
        return e - COULOMB_CONST * math.pi / (2.0 * beta * beta * vol) \
            * qtot * qtot

    return recip
