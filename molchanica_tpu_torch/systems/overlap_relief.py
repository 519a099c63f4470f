"""Host-side steric overlap relief for freshly-built systems.

Deep overlaps (r < ~1.5 A) sit in the flat (clipped) region of the LJ
potential where minimization gets no separating force; this cheap numpy/
scipy pass pushes any non-excluded pair apart to `d_min` BEFORE the system
ever reaches the device, so minimization only has mild clashes to polish
(copy of molchanica_tpu.systems.overlap_relief).
"""
from __future__ import annotations

from typing import Optional, Set, Tuple

import numpy as np
from scipy.spatial import cKDTree


def relieve_overlaps(
    positions: np.ndarray,
    box: Optional[np.ndarray],
    excluded_pairs: Set[Tuple[int, int]],
    d_min: float = 2.0,
    n_iters: int = 60,
    mobile_mask: Optional[np.ndarray] = None,
    rigid_group_id: Optional[np.ndarray] = None,
    max_step: float = 0.3,
) -> np.ndarray:
    """Iteratively separate non-excluded pairs closer than d_min.

    `rigid_group_id` (int per atom, -1 = flexible): members of a group move
    together (their pushes are averaged) — rigid waters must not be torn
    apart. Per-iteration displacement is capped at `max_step` so flexible
    molecules don't get their bonds stretched into spaghetti.
    """
    x = np.asarray(positions, np.float64).copy()
    n = len(x)
    mobile = (np.ones(n, bool) if mobile_mask is None
              else np.asarray(mobile_mask) > 0)
    if rigid_group_id is not None:
        rg = np.asarray(rigid_group_id, np.int64)
        n_groups = int(rg.max()) + 1 if (rg >= 0).any() else 0
    else:
        rg, n_groups = None, 0
    rng = np.random.default_rng(0)
    if excluded_pairs:
        ea = np.asarray([(min(i, j), max(i, j)) for i, j in excluded_pairs],
                        np.int64)
        excl_keys = set((ea[:, 0] * n + ea[:, 1]).tolist())
    else:
        excl_keys = set()
    for _ in range(n_iters):
        if box is not None:
            u = x - box * np.floor(x / box)
            # cKDTree boxsize requires points strictly inside [0, box)
            u = np.clip(u, 0.0, np.nextafter(box, 0.0))
            tree = cKDTree(u, boxsize=box)
        else:
            u = x
            tree = cKDTree(u)
        pairs = tree.query_pairs(d_min, output_type="ndarray")
        if len(pairs) == 0:
            break
        lo = np.minimum(pairs[:, 0], pairs[:, 1])
        hi = np.maximum(pairs[:, 0], pairs[:, 1])
        keys = lo * n + hi
        keep = np.asarray([k not in excl_keys for k in keys.tolist()])
        if not keep.any():
            break
        i, j = lo[keep], hi[keep]
        d = x[i] - x[j]
        if box is not None:
            d -= box * np.round(d / box)
        r = np.linalg.norm(d, axis=1)
        zero = r < 1e-6
        if zero.any():
            d[zero] = rng.normal(size=(zero.sum(), 3))
            r[zero] = np.linalg.norm(d[zero], axis=1)
        push = ((d_min - r + 0.05) * 0.5 / r)[:, None] * d
        disp = np.zeros_like(x)
        np.add.at(disp, i, push)
        np.add.at(disp, j, -push)
        if n_groups:
            gsum = np.zeros((n_groups, 3))
            gcnt = np.zeros(n_groups)
            in_g = rg >= 0
            np.add.at(gsum, rg[in_g], disp[in_g])
            np.add.at(gcnt, rg[in_g], 1.0)
            gmean = gsum / np.maximum(gcnt, 1.0)[:, None]
            disp[in_g] = gmean[rg[in_g]]
        norm = np.linalg.norm(disp, axis=1, keepdims=True)
        disp *= np.minimum(1.0, max_step / np.maximum(norm, 1e-12))
        x += disp * mobile[:, None]
    return x
