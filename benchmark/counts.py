"""The work a farm step needs, counted from sizes, and the card's peaks.

Counts are of the least work the inputs need, not of what a kernel does:
each in-cutoff pair once, each input byte read once and each output byte
written once. They never read the program, so they stay the same whatever
computes the force, and a share of a peak built on them cannot pass 100%
unless the time leaves work out.
"""
from __future__ import annotations

import math

# NVIDIA H100 SXM (data sheet, dense rates, 700 W): FP32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations per in-cutoff pair of the direct-space kernel K2
# (csrc/direct_force.cu), counted as chip_smoke.py counts them: geometry and
# the r^2 clamp 10, softcore LJ with its clip 38, the Abramowitz-Stegun
# Coulomb 30, the force accumulation 7; the reaction on the second site of
# the pair 3 more
PAIR_OPS = 10 + 38 + 30 + 7
REACTION_OPS = 3

# bytes per site per replica of one direct-space evaluation: positions and
# the (q, sigma, eps) parameters in, the force out, float32
SITE_BYTES = (3 + 3 + 3) * 4

PME_ORDER = 6


def direct_ops(pairs: int) -> float:
    """FP32 operations of one direct-space evaluation of `pairs` unordered
    in-cutoff pairs."""
    return float(pairs) * (PAIR_OPS + REACTION_OPS)


def direct_bytes(sites: int) -> float:
    return float(sites) * SITE_BYTES


def pme_ops(charged: int, grid) -> float:
    """FP32 operations of one PME force evaluation: the order-6 spread (a
    multiply and an add per mesh point of each charged site, p^3 points),
    a real 3D transform forward and back (2.5 K log2 K each, K mesh
    points), and the force gather (three components, a multiply and an add
    each per mesh point)."""
    p3 = PME_ORDER ** 3
    k = 1
    for n in grid:
        k *= int(n)
    fft = 2 * 2.5 * k * math.log2(k)
    return float(charged) * (2 * p3 + 6 * p3) + fft


def farm_step_ops(replicas: int, pairs: int, charged: int, grid) -> float:
    """FP32 operations of one farm step: two force evaluations per replica
    (the fresh force after the rebuild and the integrator's), each its
    direct space and its PME."""
    return 2.0 * replicas * (direct_ops(pairs) + pme_ops(charged, grid))


def roofline_ms(ops: float, nbytes: float) -> float:
    """The least time of a call on the card: max(ops / peak FP32, bytes /
    peak bandwidth), in ms."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
