"""Ewald splitting helpers and MdSim's reciprocal-space energy (port of
molchanica_tpu.ops.pme; the order-6 SPME itself is ops/pme3.py)."""
from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import erfc as _erfc


def ewald_beta_for(cutoff: float, rtol: float = 1e-5) -> float:
    """Solve erfc(beta * rc) = rtol by bisection."""
    lo, hi = 0.0, 10.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if _erfc(mid * cutoff) > rtol:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def good_fft_size(n: int) -> int:
    """Smallest size >= n with factors {2, 3, 5}."""
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1:
            return n
        n += 1


def default_grid(box_extent, spacing: float = 1.0):
    """MdSim's mesh: spacing <= 1 A, at least 16 points, {2,3,5} sizes."""
    return tuple(good_fft_size(max(16, int(math.ceil(b / spacing))))
                 for b in np.asarray(box_extent))


def make_pme_recip_fn(top, cfg, box_extent, device=None):
    """recip(x, box, couple) -> E_recip, differentiable in x and the box:
    order-6 SPME (ops/pme3.py) on cfg.pme_grid or default_grid(box), with
    the coupled atoms' charges scaled by couple, in cfg.dtype. `device`
    None means the CUDA card. The mesh shape is `recip.grid`."""
    from ..device import resolve_device
    from .pme3 import make_pme3_recip_fn

    dev = resolve_device(device)
    grid_shape = tuple(cfg.pme_grid or default_grid(box_extent))
    beta = ewald_beta_for(cfg.coulomb_cutoff, cfg.ewald_rtol)
    recip3 = make_pme3_recip_fn(grid_shape, beta, device=dev,
                                dtype=getattr(torch, cfg.dtype))
    charges = (top.charges * top.atom_mask).to(dev)
    cm = top.couple_mask.to(dev)

    def recip(x, box, couple):
        q_eff = charges * (1.0 - cm * (1.0 - couple))
        return recip3(x, q_eff, box)

    recip.grid = recip3.K
    return recip
