"""SPME reciprocal space: order-6 B-splines and a matmul DFT (port of
molchanica_tpu.ops.pme3 at order 6 with its analytic gradient).

The charges are spread onto the [Kx, Ky, Kz] mesh as dense products
wx^T (wy (x) wz) per chunk of atoms, the 3D DFT is three [K, K] matrix
passes, and only |S|^2 is needed for the energy. The gradient is the
classic PME force contraction against the same panels, recomputed in the
backward pass rather than stored. Energy convention: tin-foil boundary,
k = 0 dropped, net-charge background correction.

The products are float32 matmuls (float64 where `dtype` asks for it); on
the card they need ``torch.backends.cuda.matmul.allow_tf32 = False`` (set
by FastSim and MdSim). The box gradient, which the MdSim barostat's
scaling derivative needs, is analytic too: the explicit derivative of the
influence function and the volume, plus the implicit one through the
fractional coordinates u = x K / box, -(1 / box_a) sum_i x_ia dE/dx_ia.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import COULOMB_CONST
from ..device import resolve_device
from .pme import good_fft_size


def default_grid6(box_extent, beta: float = None, spacing: float = 1.3,
                  k_rtol: float = 1e-6):
    """Mesh for order-6 splines: spacing <= ~1.3 A, and the mesh Nyquist
    covers the reciprocal Gaussian tail, K >= L k_cut / pi with
    k_cut = 2 beta sqrt(ln(1/k_rtol))."""
    box = np.asarray(box_extent, np.float64)
    kmin = np.zeros(3)
    if beta is not None:
        k_cut = 2.0 * float(beta) * math.sqrt(math.log(1.0 / k_rtol))
        kmin = box * k_cut / math.pi
    return tuple(good_fft_size(max(16, int(math.ceil(b / spacing)),
                                   int(math.ceil(km))))
                 for b, km in zip(box, kmin))


def bspline_weights_and_derivs(t, order: int):
    """(M_order(t+k), dM_order(t+k)/dt) for k = 0..order-1 (Cox-de Boor;
    dM_n(u)/du = M_{n-1}(u) - M_{n-1}(u-1))."""
    k = torch.arange(order, dtype=t.dtype, device=t.device)
    u = t[..., None] + k
    M = torch.clamp_min(1.0 - torch.abs(u - 1.0), 0.0)      # M_2
    for n in range(3, order + 1):
        Mm1 = torch.cat([torch.zeros_like(M[..., :1]), M[..., :-1]], dim=-1)
        Mnew = (u * M + (n - u) * Mm1) / (n - 1)
        if n == order:
            return Mnew, M - Mm1
        M = Mnew
    raise AssertionError("order must be >= 3")


def _mn_integer_nodes(order: int) -> np.ndarray:
    """M_order(j) for j = 1..order-1."""
    u = np.arange(1, order, dtype=np.float64)
    M = np.maximum(1.0 - np.abs(u - 1.0), 0.0)
    for n in range(3, order + 1):
        Mm1 = np.concatenate([[0.0], M[:-1]])
        M = (u * M + (n - u) * Mm1) / (n - 1)
    return M


def _bspline_b2_n(K: int, order: int) -> np.ndarray:
    """|b(m)|^2 Euler exponential-spline factors for one axis."""
    nodes = _mn_integer_nodes(order)
    m = np.arange(K)
    denom = np.zeros(K, np.complex128)
    for j in range(order - 1):
        denom += nodes[j] * np.exp(2j * np.pi * m * j / K)
    return 1.0 / np.maximum(np.abs(denom) ** 2, 1e-12)


def _axis_weights(u, K, order, derivs=False):
    """Dense [A, K] spreading matrix (and its d/du) for one axis."""
    u0 = torch.floor(u)
    w, dw = bspline_weights_and_derivs(u - u0, order)        # [A, order]
    offs = torch.arange(order, device=u.device)
    idx = torch.remainder(u0.long()[:, None] - offs[None, :], K)
    W = torch.zeros((u.shape[0], K), dtype=u.dtype, device=u.device)
    W.scatter_add_(1, idx, w)
    if not derivs:
        return W
    dW = torch.zeros_like(W)
    dW.scatter_add_(1, idx, dw)
    return W, dW


class Pme3:
    """Order-6 SPME reciprocal energy on a fixed mesh; the influence
    function tracks the live box."""

    def __init__(self, grid_shape, beta, order: int = 6, chunk: int = 32768,
                 device=None, dtype=torch.float32):
        device = resolve_device(device)
        self.K = tuple(int(k) for k in grid_shape)
        self.beta = float(beta)
        self.order = order
        self.chunk = chunk
        Kx, Ky, Kz = self.K
        f32 = dict(dtype=dtype, device=device)
        self.Ks = torch.tensor(self.K, **f32)
        b2 = (_bspline_b2_n(Kx, order)[:, None, None]
              * _bspline_b2_n(Ky, order)[None, :, None]
              * _bspline_b2_n(Kz, order)[None, None, :])
        self.b2 = torch.as_tensor(b2, **f32)
        self.m = [torch.as_tensor(np.fft.fftfreq(k) * k, **f32)
                  for k in self.K]
        self.C, self.S = [], []
        for k in self.K:
            ang = -2.0 * np.pi * np.outer(np.arange(k), np.arange(k)) / k
            self.C.append(torch.as_tensor(np.cos(ang), **f32))
            self.S.append(torch.as_tensor(np.sin(ang), **f32))

    def _spread(self, x, q, box):
        Kx, Ky, Kz = self.K
        u = x / box * self.Ks
        Q = torch.zeros((Kx, Ky * Kz), dtype=x.dtype, device=x.device)
        for c0 in range(0, x.shape[0], self.chunk):
            us = u[c0:c0 + self.chunk]
            wx = _axis_weights(us[:, 0], Kx, self.order) \
                * q[c0:c0 + self.chunk, None]
            wy = _axis_weights(us[:, 1], Ky, self.order)
            wz = _axis_weights(us[:, 2], Kz, self.order)
            P = (wy[:, :, None] * wz[:, None, :]).reshape(-1, Ky * Kz)
            Q = Q + wx.T @ P
        return Q.reshape(Kx, Ky, Kz)

    def _dft3(self, QR, QI):
        """Complex 3D transform with kernel e^{-2 pi i m g / K} per axis
        (the matrices are symmetric: this is also the adjoint)."""
        (Cx, Cy, Cz), (Sx, Sy, Sz) = self.C, self.S
        ein = torch.einsum
        if QI is None:
            R = ein("xa,ayz->xyz", Cx, QR)
            I = ein("xa,ayz->xyz", Sx, QR)
        else:
            R = ein("xa,ayz->xyz", Cx, QR) - ein("xa,ayz->xyz", Sx, QI)
            I = ein("xa,ayz->xyz", Sx, QR) + ein("xa,ayz->xyz", Cx, QI)
        R2 = ein("yb,xbz->xyz", Cy, R) - ein("yb,xbz->xyz", Sy, I)
        I2 = ein("yb,xbz->xyz", Cy, I) + ein("yb,xbz->xyz", Sy, R)
        R3 = ein("zc,xyc->xyz", Cz, R2) - ein("zc,xyc->xyz", Sz, I2)
        I3 = ein("zc,xyc->xyz", Cz, I2) + ein("zc,xyc->xyz", Sz, R2)
        return R3, I3

    def _infl(self, box):
        mx, my, mz = self.m
        kx = 2.0 * math.pi * mx / box[0]
        ky = 2.0 * math.pi * my / box[1]
        kz = 2.0 * math.pi * mz / box[2]
        k2 = (kx[:, None, None] ** 2 + ky[None, :, None] ** 2
              + kz[None, None, :] ** 2)
        k2_safe = torch.where(k2 == 0.0, torch.ones_like(k2), k2)
        infl = 4.0 * math.pi / k2_safe * torch.exp(
            -k2_safe / (4.0 * self.beta * self.beta))
        return torch.where(k2 == 0.0, torch.zeros_like(infl), infl) * self.b2

    def energy_parts(self, x, q, box):
        """(E, infl * Re S, infl * Im S)."""
        R3, I3 = self._dft3(self._spread(x, q, box), None)
        infl = self._infl(box)
        vol = box[0] * box[1] * box[2]
        e = (COULOMB_CONST / (2.0 * vol)) * torch.sum(
            infl * (R3 * R3 + I3 * I3))
        qtot = torch.sum(q)
        e = e - COULOMB_CONST * math.pi / (2.0 * self.beta * self.beta
                                           * vol) * qtot * qtot
        return e, infl * R3, infl * I3

    def grads(self, x, q, box, DR, DI):
        """(dE/dx [N, 3], dE/dq [N]) from the saved influence products."""
        Kx, Ky, Kz = self.K
        vol = box[0] * box[1] * box[2]
        alpha = COULOMB_CONST / (2.0 * vol)
        phi, _ = self._dft3(DR, -DI)
        phi_flat = ((2.0 * alpha) * phi).reshape(Kx, Ky * Kz)
        u = x / box * self.Ks
        scale = self.Ks / box
        gx_all, gq_all = [], []
        for c0 in range(0, x.shape[0], self.chunk):
            us = u[c0:c0 + self.chunk]
            qs = q[c0:c0 + self.chunk]
            wx, dwx = _axis_weights(us[:, 0], Kx, self.order, True)
            wy, dwy = _axis_weights(us[:, 1], Ky, self.order, True)
            wz, dwz = _axis_weights(us[:, 2], Kz, self.order, True)
            P = (wy[:, :, None] * wz[:, None, :]).reshape(-1, Ky * Kz)
            Gx = P @ phi_flat.T                                # [c, Kx]
            T1 = (wx @ phi_flat).reshape(-1, Ky, Kz)
            Ty = torch.sum(T1 * wz[:, None, :], dim=2)
            Tz = torch.sum(T1 * wy[:, :, None], dim=1)
            gx_all.append(torch.stack([
                qs * torch.sum(dwx * Gx, dim=1) * scale[0],
                qs * torch.sum(dwy * Ty, dim=1) * scale[1],
                qs * torch.sum(dwz * Tz, dim=1) * scale[2]], dim=1))
            gq_all.append(torch.sum(wx * Gx, dim=1))
        dq_bg = -COULOMB_CONST * math.pi / (self.beta * self.beta * vol) \
            * torch.sum(q)
        return torch.cat(gx_all), torch.cat(gq_all) + dq_bg

    def value_and_grad(self, x, q, box):
        """(E, dE/dx) without building an autograd graph."""
        with torch.no_grad():
            e, DR, DI = self.energy_parts(x, q, box)
            return e, self.grads(x, q, box, DR, DI)[0]

    def box_grad(self, x, q, box, gx):
        """dE/dbox [3] at fixed x, given gx = dE/dx."""
        with torch.enable_grad():
            b = box.detach().requires_grad_(True)
            with torch.no_grad():
                R3, I3 = self._dft3(self._spread(x, q, box), None)
                s2 = R3 * R3 + I3 * I3
                qtot = torch.sum(q)
            vol = b[0] * b[1] * b[2]
            e = (COULOMB_CONST / (2.0 * vol)) * torch.sum(self._infl(b) * s2)
            e = e - COULOMB_CONST * math.pi / (2.0 * self.beta * self.beta
                                               * vol) * qtot * qtot
            (gb,) = torch.autograd.grad(e, b)
        return gb - torch.sum(x * gx, dim=0) / box

    def __call__(self, x, q, box):
        """Differentiable in x, q and the box."""
        return _Pme3Fn.apply(x, q, box, self)


class _Pme3Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, box, pme):
        e, DR, DI = pme.energy_parts(x, q, box)
        ctx.pme = pme
        ctx.save_for_backward(x, q, box, DR, DI)
        return e

    @staticmethod
    def backward(ctx, e_bar):
        x, q, box, DR, DI = ctx.saved_tensors
        gx, gq = ctx.pme.grads(x, q, box, DR, DI)
        gb = (ctx.pme.box_grad(x, q, box, gx) if ctx.needs_input_grad[2]
              else None)
        return e_bar * gx, e_bar * gq, \
            None if gb is None else e_bar * gb, None


def make_pme3_recip_fn(grid_shape, beta, device=None, dtype=torch.float32):
    """recip(x, q_eff, box) -> E_recip, order 6 with the analytic gradient
    (the reference's make_pme3_recip_fn(order=6, custom_grad=True), plus
    the box gradient that its custom_grad=False form gets from autodiff),
    on `device` (None means the CUDA card)."""
    return Pme3(grid_shape, beta, order=6, device=device, dtype=dtype)
