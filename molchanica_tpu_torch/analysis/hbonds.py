"""Hydrogen-bond detection with donor/acceptor geometry + strength scoring.

Copy of molchanica_tpu.analysis.hbonds:
the same host code, so its results equal the reference's bit for bit.

Reference: src/bond_inference.rs:66,147-336 — H-bond inference with a spatial
hash grid, donor/acceptor geometry and strength scoring; snapshots carry
`hydrogen_bonds` (src/md/trajectory.rs Snapshot field).

Criteria (standard): donor heavy atom D bonded to H; acceptor A with
D...A < dist_cutoff, D-H...A angle > angle_cutoff. Strength scored by
distance and linearity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

DONOR_ELEMENTS = {"N", "O", "S"}
ACCEPTOR_ELEMENTS = {"N", "O", "F", "S"}


@dataclass(frozen=True)
class HydrogenBond:
    """Reference `HydrogenBond` (src/molecules/mod.rs:495)."""
    donor: int          # heavy donor atom index
    hydrogen: int
    acceptor: int
    distance: float     # D...A (A)
    angle: float        # D-H...A (radians)
    strength: float     # 0..1


def find_hydrogen_bonds(
    elements: Sequence[str],
    positions: np.ndarray,
    bonds: Sequence[Tuple[int, int]],
    box: Optional[np.ndarray] = None,
    dist_cutoff: float = 3.5,
    angle_cutoff_deg: float = 120.0,
) -> List[HydrogenBond]:
    x = np.asarray(positions, float)
    el = [e.capitalize() for e in elements]
    n = len(el)
    adj = [[] for _ in range(n)]
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)

    # donors: (D, H) pairs; acceptors: N/O/F/S heavy atoms
    dh_pairs = []
    for h in range(n):
        if el[h] != "H":
            continue
        for d in adj[h]:
            if el[d] in DONOR_ELEMENTS:
                dh_pairs.append((d, h))
    acceptors = [a for a in range(n) if el[a] in ACCEPTOR_ELEMENTS]
    if not dh_pairs or not acceptors:
        return []

    from scipy.spatial import cKDTree
    acc_pos = x[acceptors]
    if box is not None:
        u = acc_pos - box * np.floor(acc_pos / box)
        u = np.clip(u, 0, np.nextafter(box, 0))
        tree = cKDTree(u, boxsize=box)
    else:
        tree = cKDTree(acc_pos)

    ang_min = math.radians(angle_cutoff_deg)
    out: List[HydrogenBond] = []
    for d, h in dh_pairs:
        hp = x[h]
        if box is not None:
            hq = hp - box * np.floor(hp / box)
            hq = np.clip(hq, 0, np.nextafter(box, 0))
        else:
            hq = hp
        for ai in tree.query_ball_point(hq, dist_cutoff):
            a = acceptors[ai]
            if a == d or a in adj[h]:
                continue
            dv = x[a] - x[d]
            hv = x[a] - x[h]
            dh = x[h] - x[d]
            if box is not None:
                dv -= box * np.round(dv / box)
                hv -= box * np.round(hv / box)
                dh -= box * np.round(dh / box)
            r_da = float(np.linalg.norm(dv))
            if r_da > dist_cutoff or r_da < 0.5:
                continue
            # angle D-H...A at H
            v1 = -dh
            v2 = hv
            c = float(np.dot(v1, v2)
                      / max(np.linalg.norm(v1) * np.linalg.norm(v2), 1e-9))
            ang = math.acos(np.clip(c, -1.0, 1.0))
            if ang < ang_min:
                continue
            # strength: distance falloff x linearity (reference-style score)
            s_dist = max(0.0, 1.0 - (r_da - 2.6) / (dist_cutoff - 2.6)) \
                if r_da > 2.6 else 1.0
            s_ang = (ang - ang_min) / (math.pi - ang_min)
            out.append(HydrogenBond(
                donor=d, hydrogen=h, acceptor=a, distance=r_da,
                angle=ang, strength=float(s_dist * s_ang)))
    return out
