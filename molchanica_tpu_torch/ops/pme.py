"""Ewald splitting helpers (port of the host-side part of
molchanica_tpu.ops.pme)."""
from __future__ import annotations

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
