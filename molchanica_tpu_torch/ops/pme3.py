"""SPME reciprocal space: order-6 B-splines and a matmul DFT (port of
molchanica_tpu.ops.pme3 at order 6 with its analytic gradient).

The charges are spread onto the [Kx, Ky, Kz] mesh, the 3D DFT is three
[K, K] matrix passes, and only |S|^2 is needed for the energy. The
gradient is the classic PME force contraction, a gather of the mesh
potential at each atom's 216 stencil points, recomputed in the backward
pass rather than stored. Energy convention: tin-foil boundary, k = 0
dropped, net-charge background correction.

The spread and the gather dispatch on the tensors' device: CUDA tensors
go to the stencil kernels of csrc/pme_stencil.cu (`pme_spread_cuda`,
`pme_gather_cuda`; one launch each for every replica, with any leading
replica axis), CPU tensors to the plain version, the dense products
wx^T (wy (x) wz) per chunk of atoms (`Pme3._spread_plain`,
`Pme3._gather_plain`), which the JAX package computes too. The DFT's
products are float32 matmuls (float64 where `dtype` asks for it); on the
card they need ``torch.backends.cuda.matmul.allow_tf32 = False`` (set by
FastSim and MdSim). The box gradient, which the MdSim barostat's scaling
derivative needs, is analytic too: the explicit derivative of the
influence function and the volume, plus the implicit one through the
fractional coordinates u = x K / box, -(1 / box_a) sum_i x_ia dE/dx_ia.
"""
from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from .. import tracing
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
    zero = torch.zeros((u.shape[0], K), dtype=u.dtype, device=u.device)
    W = zero.scatter_add(1, idx, w)        # out of place: vmap batches it
    if not derivs:
        return W
    return W, zero.scatter_add(1, idx, dw)


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
        self._box_ref = self._box_key = self._box_vals = None

    def _spread(self, x, q, box):
        """Q [..., Kx, Ky, Kz] of x [..., N, 3] and q [..., N]: the stencil
        kernel for CUDA tensors (any leading replica axis), the dense plain
        version for CPU tensors (x [N, 3])."""
        if x.device.type == "cuda":
            return pme_spread_cuda(self.K, x, q, box)
        return self._spread_plain(x, q, box)

    def _spread_plain(self, x, q, box):
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
        (the matrices are symmetric: this is also the adjoint), over the
        last three axes. Each axis is a matrix product over a leading
        batch (the replicas, then the mesh rows) that copies no operand;
        each pass's inputs are dropped once it is done and its differences
        formed in place, so that at most seven meshes are alive at once
        (config 3's 13 replicas: 11.2 MB a mesh)."""
        (Cx, Cy, Cz), (Sx, Sy, Sz) = self.C, self.S

        def along_x(M, A):                      # "xa,...ayz->...xyz"
            return torch.matmul(M, A.reshape(A.shape[:-2] + (-1,))) \
                .reshape(A.shape)

        along_y = torch.matmul                  # "yb,...xbz->...xyz"

        def along_z(M, A):                      # "zc,...xyc->...xyz"
            return torch.matmul(A, M.T)

        if QI is None:
            R = along_x(Cx, QR)
            I = along_x(Sx, QR)
        else:
            R = along_x(Cx, QR).sub_(along_x(Sx, QI))
            I = along_x(Sx, QR).add_(along_x(Cx, QI))
        del QR, QI
        R2 = along_y(Cy, R).sub_(along_y(Sy, I))
        I2 = along_y(Cy, I).add_(along_y(Sy, R))
        del R, I
        R3 = along_z(Cz, R2).sub_(along_z(Sz, I2))
        I3 = along_z(Cz, I2).add_(along_z(Sz, R2))
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

    def _box_terms(self, box):
        """(infl, C / (2 vol), C pi / (2 beta^2 vol), C / vol,
        -C pi / (beta^2 vol)) of the box, kept while the same box tensor
        comes back unmodified (a farm's or a fixed-volume run's box is one
        tensor for the run): some 30 launches an evaluation."""
        # an inference tensor keeps no version counter: it is not kept
        key = None if box.is_inference() else (box._version, box.dtype,
                                                box.device)
        if key is not None and self._box_key == key \
                and self._box_ref() is box:
            return self._box_vals
        vol = box[0] * box[1] * box[2]
        alpha = COULOMB_CONST / (2.0 * vol)
        vals = (self._infl(box), alpha,
                COULOMB_CONST * math.pi / (2.0 * self.beta * self.beta * vol),
                2.0 * alpha,
                -COULOMB_CONST * math.pi / (self.beta * self.beta * vol))
        if key is not None:
            self._box_ref, self._box_key, self._box_vals = \
                weakref.ref(box), key, vals
        return vals

    def energy_parts(self, x, q, box):
        """(E, infl * Re S, infl * Im S), with the leading replica axis of
        x [..., N, 3] and q [..., N] (CUDA tensors; the CPU's dense version
        takes one replica)."""
        R3, I3 = self._dft3(self._spread(x, q, box), None)
        infl, alpha, bg, _, _ = self._box_terms(box)
        e = alpha * torch.sum(infl * (R3 * R3 + I3 * I3), dim=(-3, -2, -1))
        qtot = torch.sum(q, dim=-1)
        e = e - bg * qtot * qtot
        return e, infl * R3, infl * I3

    def grads(self, x, q, box, DR, DI):
        """(dE/dx [..., N, 3], dE/dq [..., N]) from the saved influence
        products: the mesh potential gathered at each atom's stencil, by
        the kernel for CUDA tensors and the dense version for CPU ones."""
        _, _, _, two_alpha, dq_bg = self._box_terms(box)
        phi, _ = self._dft3(DR, -DI)
        phi = two_alpha * phi
        if x.device.type == "cuda":
            gx, gq = pme_gather_cuda(self.K, x, q, box, phi)
        else:
            gx, gq = self._gather_plain(x, q, box, phi)
        return gx, gq + dq_bg * torch.sum(q, dim=-1, keepdim=True)

    def _gather_plain(self, x, q, box, phi):
        Kx, Ky, Kz = self.K
        phi_flat = phi.reshape(Kx, Ky * Kz)
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
        return torch.cat(gx_all), torch.cat(gq_all)

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

    def batched(self, x, q, box):
        """[R] energies of R independent charge sets (x [R, N, 3], q [R,
        N]) on one box: one spread and one gather launch for the R
        replicas on the card, torch.func.vmap of energy_parts and grads on
        the CPU. Differentiable in x and q."""
        if box.requires_grad:
            raise ValueError("Pme3.batched: no box gradient")
        return _Pme3BatchFn.apply(x, q, box, self)


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


def _per_replica(fn, x, in_dims):
    """fn over x's leading replica axis: as it is for CUDA tensors (the
    kernels take the axis), vmapped for the CPU's dense version."""
    if x.device.type == "cuda":
        return fn
    from torch.func import vmap
    return vmap(fn, in_dims=in_dims)


class _Pme3BatchFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, box, pme):
        e, DR, DI = _per_replica(pme.energy_parts, x, (0, 0, None))(
            x, q, box)
        ctx.pme = pme
        ctx.save_for_backward(x, q, box, DR, DI)
        return e

    @staticmethod
    def backward(ctx, e_bar):
        with tracing.span("pme.backward"):
            x, q, box, DR, DI = ctx.saved_tensors
            gx, gq = _per_replica(ctx.pme.grads, x, (0, 0, None, 0, 0))(
                x, q, box, DR, DI)
            return e_bar[:, None, None] * gx, e_bar[:, None] * gq, None, None


def make_pme3_recip_fn(grid_shape, beta, device=None, dtype=torch.float32):
    """recip(x, q_eff, box) -> E_recip, order 6 with the analytic gradient
    (the reference's make_pme3_recip_fn(order=6, custom_grad=True), plus
    the box gradient that its custom_grad=False form gets from autodiff),
    on `device` (None means the CUDA card)."""
    return Pme3(grid_shape, beta, order=6, device=device, dtype=dtype)


def _stencil_args(name, K, x, q, box, mesh=None):
    """(lead, R, n, box on x's device and dtype) for a stencil launch, or
    ValueError on what the kernels do not take."""
    dev, dt = x.device, x.dtype
    lead = tuple(x.shape[:-2])
    R = x.shape[0] if lead else 1
    n = x.shape[-2] if x.dim() >= 2 else -1
    box = torch.as_tensor(box, dtype=dt, device=dev)
    if len(lead) > 1 or x.shape != lead + (n, 3) or q.shape != lead + (n,) \
            or box.shape != (3,) or not 0 < R < 65536 or min(K) < 6 \
            or (mesh is not None and mesh.shape != lead + tuple(K)):
        raise ValueError(
            f"{name}: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, box "
            f"{tuple(box.shape)}"
            + ("" if mesh is None else f", mesh {tuple(mesh.shape)}")
            + f": want [R,] [N, 3], [R,] [N], [3]"
            + ("" if mesh is None else f", [R,] {list(K)}")
            + "; R < 65,536, every mesh side at least 6")
    tensors = [x, q, box] + ([] if mesh is None else [mesh])
    if dt not in (torch.float32, torch.float64) \
            or any(t.dtype != dt for t in tensors):
        raise ValueError(f"{name}: dtypes {[t.dtype for t in tensors]}: "
                         f"want float32 or float64, all the same")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(f"{name}: the kernel gives no gradient; Pme3's "
                         f"autograd Functions call it")
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must lie on one CUDA "
                         f"device, x lies on {dev}")
    return lead, R, n, box.contiguous()


def pme_spread_cuda(K, x, q, box):
    """Q [R, Kx, Ky, Kz] (or [Kx, Ky, Kz] without the replica axis): the
    charges q [R, N] at x [R, N, 3] spread on the mesh K by
    csrc/pme_stencil.cu, one launch on the current stream for the R
    replicas (and one conversion of its fixed-point sums), in x's dtype
    (float32 or float64). Deterministic: the same bits on every launch; the
    sums must stay below 2^17 e at every mesh point. box [3] on the card
    is read there (a host value is copied at each call). The tracing
    counter "pme_spread" counts each launch."""
    import ctypes

    from ..cuda_build import load_library

    lead, R, n, box = _stencil_args("pme_spread", K, x, q, box)
    x, q = x.contiguous(), q.contiguous()
    acc = torch.zeros(lead + tuple(K), dtype=torch.int64, device=x.device)
    mesh = torch.empty(lead + tuple(K), dtype=x.dtype, device=x.device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = load_library().pme_spread_launch(
        int(x.dtype == torch.float64), R, n, *K, ptr(x), ptr(q), ptr(box),
        ptr(acc), ptr(mesh),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"pme_spread kernel launch failed: CUDA error "
                           f"{err}")
    tracing.count("pme_spread")
    return mesh


def pme_gather_cuda(K, x, q, box, phi):
    """(dE/dx [R, N, 3], dE/dq [R, N]) from the mesh potential phi [R, Kx,
    Ky, Kz] (the inverse DFT of the influence products, scaled by 2 alpha)
    at the stencils of x [R, N, 3] by csrc/pme_stencil.cu, one launch on
    the current stream for the R replicas (the replica axis is optional);
    dE/dq leaves out the net-charge background term. Deterministic: the
    same bits on every launch. The tracing counter "pme_gather" counts
    each launch."""
    import ctypes

    from ..cuda_build import load_library

    lead, R, n, box = _stencil_args("pme_gather", K, x, q, box, phi)
    x, q, phi = x.contiguous(), q.contiguous(), phi.contiguous()
    gx = torch.empty_like(x)
    gq = torch.empty_like(q)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = load_library().pme_gather_launch(
        int(x.dtype == torch.float64), R, n, *K, ptr(x), ptr(q), ptr(box),
        ptr(phi), ptr(gx), ptr(gq),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"pme_gather kernel launch failed: CUDA error "
                           f"{err}")
    tracing.count("pme_gather")
    return gx, gq
