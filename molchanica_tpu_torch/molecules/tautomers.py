"""Tautomer enumeration (1,3-shifts along conjugated paths).

Copy of molchanica_tpu.molecules.tautomers:
the same host code, so its results equal the reference's bit for bit.

Reference: src/tautomers.rs (caps: path <= 8 bonds, <= 512 tautomers).
Topology-level enumeration: moves an H from a donor heteroatom/carbon
alpha to a multiple bond onto the acceptor atom, flipping bond orders along
the path (keto-enol, amide-imidol, etc.).
"""
from __future__ import annotations

import copy
from typing import List, Tuple

from .common import MoleculeCommon

MAX_PATH_BONDS = 8
MAX_TAUTOMERS = 512


def enumerate_tautomers(mol: MoleculeCommon) -> List[MoleculeCommon]:
    """Returns [mol, *tautomers] (first entry is the input form)."""
    el = [e.capitalize() for e in mol.elements]
    n = len(el)
    if mol.bond_orders is None:
        return [mol]
    adj = [[] for _ in range(n)]
    border = {}
    for bi, (i, j) in enumerate(mol.bonds):
        adj[i].append(j)
        adj[j].append(i)
        border[(i, j)] = border[(j, i)] = bi

    out = [mol]
    seen_keys = {_key(mol)}

    # 1,3-shift: H-D-A=B  ->  D=A-B-H  (D donor with H; B acceptor)
    for d in range(n):
        if el[d] not in ("O", "N", "S", "C"):
            continue
        hs = [h for h in adj[d] if el[h] == "H"]
        if not hs:
            continue
        for a in adj[d]:
            if el[a] == "H":
                continue
            if mol.bond_orders[border[(d, a)]] != 1.0:
                continue
            for b in adj[a]:
                if b == d or el[b] == "H":
                    continue
                if mol.bond_orders[border[(a, b)]] != 2.0:
                    continue
                if el[b] not in ("O", "N", "S", "C"):
                    continue
                if el[d] == "C" and el[b] == "C":
                    continue   # plain allylic shift: skip
                t = _shift(mol, hs[0], d, a, b, border)
                k = _key(t)
                if k not in seen_keys:
                    seen_keys.add(k)
                    out.append(t)
                if len(out) >= MAX_TAUTOMERS:
                    return out
    return out


def _shift(mol, h, d, a, b, border) -> MoleculeCommon:
    t = copy.deepcopy(mol)
    # move H bond d-h -> b-h
    for bi, (i, j) in enumerate(t.bonds):
        if {i, j} == {d, h}:
            t.bonds[bi] = (b, h)
            break
    t.bond_orders[border[(d, a)]] = 2.0
    t.bond_orders[border[(a, b)]] = 1.0
    # crude H placement near the acceptor
    import numpy as np
    if t.positions is not None and len(t.positions):
        x = np.asarray(t.positions, float)
        dirn = x[b] - x[a]
        nl = np.linalg.norm(dirn)
        if nl > 1e-6:
            x[h] = x[b] + dirn / nl * 1.0
        t.positions = x
    return t


def _key(mol) -> tuple:
    orders = tuple(round(float(o), 1) for o in (mol.bond_orders or []))
    bonds = tuple(sorted((min(i, j), max(i, j)) for i, j in mol.bonds))
    return (bonds, orders)
