"""3D coordinate embedding for bond graphs (SMILES -> geometry).

Copy of molchanica_tpu.molecules.embed:
the same host code, so its results equal the reference's bit for bit.

Two stages: (1) force-directed spring layout in 3D — bonded springs at
element-pair lengths, angle-opening 1-3 springs, and short-range
repulsion — which untangles the graph and closes rings; (2) consumers
(MdSim init relaxation / conformer search) polish with the real force
field. Deterministic per seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

_BOND_LEN = {
    ("C", "C"): 1.53, ("C", "N"): 1.47, ("C", "O"): 1.43,
    ("C", "S"): 1.81, ("C", "H"): 1.09, ("N", "H"): 1.01,
    ("O", "H"): 0.96, ("S", "H"): 1.34, ("N", "N"): 1.42,
    ("N", "O"): 1.40, ("O", "O"): 1.45, ("C", "F"): 1.35,
    ("C", "Cl"): 1.79, ("C", "Br"): 1.95, ("C", "I"): 2.14,
    ("S", "S"): 2.05, ("C", "P"): 1.84, ("O", "P"): 1.60,
}


def _blen(ea: str, eb: str) -> float:
    a, b = ea.capitalize(), eb.capitalize()
    return _BOND_LEN.get((a, b)) or _BOND_LEN.get((b, a)) or 1.5


def embed_3d(mol, seed: int = 0, n_iters: int = 400,
             lr: float = 0.05) -> np.ndarray:
    """[n, 3] coordinates from elements + bonds (force-directed)."""
    n = mol.n_atoms
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 0.5, (n, 3))
    x[:, 0] += np.arange(n) * 0.3          # break symmetry along a chain

    bonds = [(a, b, _blen(mol.elements[a], mol.elements[b]))
             for a, b in mol.bonds]
    adj = [[] for _ in range(n)]
    for a, b, r0 in bonds:
        adj[a].append((b, r0))
        adj[b].append((a, r0))
    # 1-3 targets: open angles (~109.5 deg between unit bond vectors)
    one_three = []
    for j in range(n):
        nb = adj[j]
        for p in range(len(nb)):
            for q in range(p + 1, len(nb)):
                (a, ra), (b, rb) = nb[p], nb[q]
                d13 = np.sqrt(ra * ra + rb * rb
                              - 2 * ra * rb * np.cos(np.deg2rad(111.0)))
                one_three.append((a, b, d13))

    bi = np.asarray([(a, b) for a, b, _ in bonds], int).reshape(-1, 2)
    br = np.asarray([r for _, _, r in bonds])
    ti = np.asarray([(a, b) for a, b, _ in one_three], int).reshape(-1, 2)
    tr = np.asarray([r for _, _, r in one_three])
    excl = set((min(a, b), max(a, b)) for a, b, _ in bonds)
    excl |= set((min(a, b), max(a, b)) for a, b, _ in one_three)

    for it in range(n_iters):
        g = np.zeros_like(x)
        if len(bi):
            d = x[bi[:, 0]] - x[bi[:, 1]]
            r = np.linalg.norm(d, axis=1) + 1e-9
            f = (2.0 * (r - br) / r)[:, None] * d
            np.add.at(g, bi[:, 0], f)
            np.add.at(g, bi[:, 1], -f)
        if len(ti):
            d = x[ti[:, 0]] - x[ti[:, 1]]
            r = np.linalg.norm(d, axis=1) + 1e-9
            f = (0.6 * (r - tr) / r)[:, None] * d
            np.add.at(g, ti[:, 0], f)
            np.add.at(g, ti[:, 1], -f)
        # soft repulsion for non-bonded pairs closer than 2.2 A
        dmat = x[:, None, :] - x[None, :, :]
        rmat = np.linalg.norm(dmat, axis=-1) + np.eye(n) * 9.0
        close = rmat < 2.2
        for (a, b) in excl:
            close[a, b] = close[b, a] = False
        if close.any():
            w = np.where(close, (2.2 - rmat) / (rmat + 1e-9), 0.0)
            g -= np.einsum("ij,ijk->ik", w, dmat) * 0.8
        x -= lr * g
    return x - x.mean(axis=0)


def ensure_coordinates(mol, seed: int = 0):
    """Embed in place if the molecule has no real geometry yet."""
    p = np.asarray(mol.positions, float)
    if p.size == 0 or np.allclose(p, p[0:1], atol=1e-6):
        mol.positions = embed_3d(mol, seed=seed)
    return mol
