"""Local-geometry construction helpers (editor support + H addition).

Copy of molchanica_tpu.molecules.geometry:
the same host code, so its results equal the reference's bit for bit.

Reference surface: find_tetra_posits / find_planar_posits etc.
(src/molecules/common.rs:397-525) — given a center and its
known neighbors, propose positions completing ideal tetrahedral / trigonal
geometry. numpy host-side (these run at build/edit time, not in the MD hot
path).
"""
from __future__ import annotations

import numpy as np


def _unit(v):
    n = np.linalg.norm(v)
    return v / n if n > 1e-12 else np.array([1.0, 0.0, 0.0])


def _any_perp(v):
    v = _unit(v)
    ref = np.array([1.0, 0.0, 0.0])
    if abs(v @ ref) > 0.9:
        ref = np.array([0.0, 1.0, 0.0])
    return _unit(np.cross(v, ref))


def find_tetra_posits(center, known, bond_len):
    """Positions completing ideal sp3 geometry around `center`.

    known: [k, 3] existing substituent positions (k in 0..4).
    Returns [(4-k), 3] proposed positions at distance bond_len.
    """
    center = np.asarray(center, float)
    known = np.atleast_2d(np.asarray(known, float)) if len(known) else \
        np.zeros((0, 3))
    k = known.shape[0]
    cos_t = -1.0 / 3.0                      # 109.47 deg
    if k == 0:
        # arbitrary tetrahedron
        dirs = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                        float) / np.sqrt(3.0)
        return center + bond_len * dirs
    u = [_unit(p - center) for p in known]
    if k == 1:
        a = u[0]
        p = _any_perp(a)
        out = []
        for ang in (0.0, 2 * np.pi / 3, 4 * np.pi / 3):
            q = p * np.cos(ang) + np.cross(a, p) * np.sin(ang)
            d = cos_t * a + np.sqrt(1 - cos_t ** 2) * q
            out.append(center + bond_len * _unit(d))
        return np.asarray(out)
    if k == 2:
        b1, b2 = u
        bis = -_unit(b1 + b2)
        perp = _unit(np.cross(b1, b2))
        half = 0.5 * np.arccos(cos_t)       # ~54.7 deg around the bisector
        out = []
        for s in (+1.0, -1.0):
            d = bis * np.cos(half) + s * perp * np.sin(half)
            out.append(center + bond_len * _unit(d))
        return np.asarray(out)
    if k == 3:
        d = -_unit(u[0] + u[1] + u[2])
        return (center + bond_len * d)[None]
    return np.zeros((0, 3))


def find_planar_posits(center, known, bond_len):
    """Positions completing trigonal-planar (sp2) geometry around `center`.

    known: [k, 3] existing substituents (k in 1..3).
    """
    center = np.asarray(center, float)
    known = np.atleast_2d(np.asarray(known, float))
    k = known.shape[0]
    u = [_unit(p - center) for p in known]
    if k == 1:
        a = u[0]
        p = _any_perp(a)
        out = []
        for s in (+1.0, -1.0):
            d = -0.5 * a + s * (np.sqrt(3) / 2) * p
            out.append(center + bond_len * _unit(d))
        return np.asarray(out)
    if k == 2:
        d = -_unit(u[0] + u[1])
        return (center + bond_len * d)[None]
    return np.zeros((0, 3))
