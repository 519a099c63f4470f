"""Docking sites and simple pocket finding.

Copy of molchanica_tpu.docking.site:
the same host code, so its results equal the reference's bit for bit.

Reference: DockingSite{site_center, site_radius} (src/docking/mod.rs:34),
grid-based site finding (src/docking/legacy/find_sites.rs, 5 A grid spacing
per src/docking/legacy/mod.rs:70).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class DockingSite:
    site_center: Tuple[float, float, float]
    site_radius: float = 8.0


def find_sites(receptor_positions, probe_radius: float = 4.0,
               grid_spacing: float = 5.0, min_buried: int = 8,
               max_sites: int = 5) -> List[DockingSite]:
    """Grid-scan pocket detection: probe points near the surface that are
    surrounded by receptor atoms in many directions but not clashing."""
    x = np.asarray(receptor_positions)
    lo, hi = x.min(0) - probe_radius, x.max(0) + probe_radius
    grids = [np.arange(lo[d], hi[d], grid_spacing) for d in range(3)]
    pts = np.stack(np.meshgrid(*grids, indexing="ij"), -1).reshape(-1, 3)
    scores = []
    dirs = _sphere_dirs(14)
    from scipy.spatial import cKDTree
    tree = cKDTree(x)
    d_min, _ = tree.query(pts, k=1)
    candidates = pts[(d_min > 2.5) & (d_min < probe_radius + 2.0)]
    for p in candidates:
        buried = 0
        for u in dirs:
            hits = tree.query_ball_point(p + u * 6.0, 3.5)
            if hits:
                buried += 1
        if buried >= min_buried:
            scores.append((buried, p))
    scores.sort(key=lambda t: -t[0])
    out: List[DockingSite] = []
    for buried, p in scores:
        if any(np.linalg.norm(np.asarray(s.site_center) - p) < 8.0
               for s in out):
            continue
        out.append(DockingSite(tuple(float(v) for v in p), 8.0))
        if len(out) >= max_sites:
            break
    return out


def _sphere_dirs(n):
    """Fibonacci sphere directions."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], -1)
