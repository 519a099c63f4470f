"""Pose enumeration: positions x orientations x torsions.

Copy of molchanica_tpu.docking.poses:
the same host code, so its results equal the reference's bit for bit.

Reference: init_poses (src/docking/legacy/mod.rs:460): 8^3 grid positions x
60 orientations x 3 angles per flexible bond. Here poses are generated
host-side as transform parameters and materialized on-device as a batched
coordinate tensor [P, L, 3].
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np


def fibonacci_orientations(n: int) -> np.ndarray:
    """~Uniform rotations: Fibonacci-sphere axes x golden-angle rolls -> quats."""
    out = []
    n_axes = max(1, int(round(n ** (2 / 3))))
    n_roll = max(1, n // n_axes)
    i = np.arange(n_axes) + 0.5
    phi = np.arccos(1 - 2 * i / n_axes)
    theta = np.pi * (1 + 5 ** 0.5) * i
    axes = np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
    for ax in axes:
        for k in range(n_roll):
            ang = 2 * np.pi * k / n_roll
            out.append(np.concatenate([[np.cos(ang / 2)],
                                       np.sin(ang / 2) * ax]))
    return np.asarray(out[:n])


def quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def apply_torsion(coords: np.ndarray, bond: Tuple[int, int],
                  moving: Sequence[int], angle: float) -> np.ndarray:
    """Rotate `moving` atoms about the bond axis by `angle` (radians)."""
    a, b = bond
    axis = coords[b] - coords[a]
    axis = axis / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + s * K + (1 - c) * (K @ K)
    out = coords.copy()
    out[list(moving)] = (coords[list(moving)] - coords[a]) @ R.T + coords[a]
    return out


def init_poses(
    ligand_coords: np.ndarray,
    site_center,
    site_radius: float = 8.0,
    n_grid: int = 8,
    n_orientations: int = 60,
    torsions: Optional[List[Tuple[Tuple[int, int], Sequence[int]]]] = None,
    angles_per_torsion: int = 3,
    max_poses: Optional[int] = None,
    seed: int = 0,
) -> np.ndarray:
    """Enumerate poses -> [P, L, 3] (reference budget: 8^3 x 60 x 3^n).

    torsions: list of ((i, j), moving_atom_indices) rotatable bonds.
    """
    lig = np.asarray(ligand_coords, np.float64)
    lig = lig - lig.mean(axis=0)
    center = np.asarray(site_center, np.float64)

    # conformers from torsion enumeration
    confs = [lig]
    if torsions:
        for bond, moving in torsions:
            new = []
            for c in confs:
                for k in range(angles_per_torsion):
                    ang = 2 * np.pi * k / angles_per_torsion
                    new.append(apply_torsion(c, bond, moving, ang)
                               if k else c)
            confs = new
    confs = np.asarray(confs)                 # [C, L, 3]

    quats = fibonacci_orientations(n_orientations)
    rots = quat_to_mat(quats)                 # [O, 3, 3]

    g = np.linspace(-site_radius * 0.7, site_radius * 0.7, n_grid)
    offsets = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    offsets = offsets[np.linalg.norm(offsets, axis=1) <= site_radius]

    # [C*O, L, 3] rotated conformers, then translate over grid
    rotated = np.einsum("oij,clj->coli", rots, confs)
    rotated = rotated.reshape(-1, lig.shape[0], 3)
    poses = (rotated[None, :, :, :] + (center + offsets)[:, None, None, :])
    poses = poses.reshape(-1, lig.shape[0], 3)
    if max_poses is not None and len(poses) > max_poses:
        rng = np.random.default_rng(seed)
        poses = poses[rng.choice(len(poses), max_poses, replace=False)]
    return poses.astype(np.float32)
