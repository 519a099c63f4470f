"""SMILES writer (ring-closure DFS) and a pragmatic reader.

Copy of molchanica_tpu.molecules.smiles:
the same host code, so its results equal the reference's bit for bit.

Reference: `to_smiles` writer with ring-closure DFS (src/smiles.rs:17).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .common import MoleculeCommon

_ORGANIC = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I"}
_BOND_OUT = {1.0: "", 2.0: "=", 3.0: "#", 1.5: ""}


def to_smiles(mol: MoleculeCommon, include_h: bool = False) -> str:
    """DFS SMILES with ring-closure digits. Aromatic bonds (order 1.5) are
    emitted as lowercase aromatic atoms."""
    el = [e.capitalize() for e in mol.elements]
    n = len(el)
    adj: List[List[int]] = [[] for _ in range(n)]
    order = {}
    for bi, (i, j) in enumerate(mol.bonds):
        adj[i].append(j)
        adj[j].append(i)
        o = 1.0 if mol.bond_orders is None else float(mol.bond_orders[bi])
        order[(i, j)] = order[(j, i)] = o

    aromatic = set()
    for i in range(n):
        if any(order.get((i, j)) == 1.5 for j in adj[i]):
            aromatic.add(i)

    skip_h = not include_h
    visible = [i for i in range(n) if not (skip_h and el[i] == "H")]
    if not visible:
        return ""
    vis_set = set(visible)

    # ring-closure bond detection via DFS spanning tree
    visited = set()
    tree: Dict[int, List[int]] = {i: [] for i in visible}
    closures: List[Tuple[int, int]] = []
    out_parts: List[str] = []

    def atom_token(i):
        sym = el[i]
        tok = sym.lower() if i in aromatic else sym
        fc = (mol.formal_charges[i]
              if mol.formal_charges is not None else 0)
        n_h = sum(1 for j in adj[i] if el[j] == "H") if skip_h else 0
        needs_brackets = sym not in _ORGANIC or fc != 0
        if needs_brackets:
            htok = "" if n_h == 0 else ("H" if n_h == 1 else f"H{n_h}")
            ctok = ""
            if fc > 0:
                ctok = "+" if fc == 1 else f"+{fc}"
            elif fc < 0:
                ctok = "-" if fc == -1 else f"-{-fc}"
            return f"[{tok}{htok}{ctok}]"
        return tok

    closure_digits: Dict[Tuple[int, int], int] = {}
    next_digit = [1]

    def dfs_mark(i, parent):
        visited.add(i)
        for j in adj[i]:
            if j not in vis_set or j == parent:
                continue
            if j in visited:
                key = (min(i, j), max(i, j))
                if key not in closure_digits:
                    closure_digits[key] = next_digit[0]
                    next_digit[0] += 1
            else:
                tree[i].append(j)
                dfs_mark(j, i)

    def emit(i, parent) -> str:
        s = atom_token(i)
        for key, digit in closure_digits.items():
            if i in key:
                a, b = key
                o = order.get((a, b), 1.0)
                s += _BOND_OUT.get(o, "") + (
                    str(digit) if digit < 10 else f"%{digit}")
        kids = tree[i]
        parts = []
        for k, j in enumerate(kids):
            o = order.get((i, j), 1.0)
            btok = "" if (i in aromatic and j in aromatic) \
                else _BOND_OUT.get(o, "")
            sub = btok + emit(j, i)
            parts.append(sub)
        if not parts:
            return s
        return s + "".join(f"({p})" for p in parts[:-1]) + parts[-1]

    roots = []
    for i in visible:
        if i not in visited:
            dfs_mark(i, None)
            roots.append(i)
    return ".".join(emit(r, None) for r in roots)


def from_smiles(smiles: str) -> MoleculeCommon:
    """Minimal SMILES reader: organic subset, branches, ring closures,
    -/=/# bonds, aromatic lowercase (kekulized as order 1.5). No
    stereochemistry; positions are zeros (generate with conformers).
    As in the reference, the bond marks / and \\ are read as atoms of
    those symbols, which typing then refuses."""
    elements: List[str] = []
    bonds: List[Tuple[int, int]] = []
    orders: List[float] = []
    charges: List[int] = []
    stack: List[int] = []
    ring: Dict[int, Tuple[int, float]] = {}
    prev = -1
    pending = 1.0
    aromatic_flags: List[bool] = []
    i = 0
    s = smiles
    while i < len(s):
        c = s[i]
        if c == "(":
            stack.append(prev)
            i += 1
            continue
        if c == ")":
            prev = stack.pop()
            i += 1
            continue
        if c in "-=#:":
            pending = {"-": 1.0, "=": 2.0, "#": 3.0, ":": 1.5}[c]
            i += 1
            continue
        if c.isdigit() or c == "%":
            if c == "%":
                num = int(s[i + 1:i + 3])
                i += 3
            else:
                num = int(c)
                i += 1
            if num in ring:
                j, o = ring.pop(num)
                o2 = max(o, pending)
                if aromatic_flags[prev] and aromatic_flags[j]:
                    o2 = 1.5
                bonds.append((j, prev))
                orders.append(o2)
            else:
                ring[num] = (prev, pending)
            pending = 1.0
            continue
        if c == "[":
            end = s.index("]", i)
            body = s[i + 1:end]
            # strip isotopes
            k = 0
            while k < len(body) and body[k].isdigit():
                k += 1
            body = body[k:]
            sym = body[0]
            k = 1
            if k < len(body) and body[k].islower() and \
                    (sym.upper() + body[k]) in ("Cl", "Br"):
                sym += body[k]
                k += 1
            arom = sym[0].islower()
            fc = 0
            nh = 0
            rest = body[k:]
            m = 0
            while m < len(rest):
                if rest[m] == "H":
                    nh = 1
                    if m + 1 < len(rest) and rest[m + 1].isdigit():
                        nh = int(rest[m + 1])
                        m += 1
                elif rest[m] == "+":
                    fc += 1
                    if m + 1 < len(rest) and rest[m + 1].isdigit():
                        fc = int(rest[m + 1])
                        m += 1
                elif rest[m] == "-":
                    fc -= 1
                    if m + 1 < len(rest) and rest[m + 1].isdigit():
                        fc = -int(rest[m + 1])
                        m += 1
                m += 1
            idx = len(elements)
            elements.append(sym.capitalize())
            aromatic_flags.append(arom)
            charges.append(fc)
            if prev >= 0:
                o = 1.5 if (arom and aromatic_flags[prev]) else pending
                bonds.append((prev, idx))
                orders.append(o)
            for _ in range(nh):
                h = len(elements)
                elements.append("H")
                aromatic_flags.append(False)
                charges.append(0)
                bonds.append((idx, h))
                orders.append(1.0)
            prev = idx
            pending = 1.0
            i = end + 1
            continue
        # organic subset atom
        sym = c
        if i + 1 < len(s) and (c + s[i + 1]) in ("Cl", "Br"):
            sym = c + s[i + 1]
            i += 1
        arom = sym[0].islower()
        idx = len(elements)
        elements.append(sym.capitalize())
        aromatic_flags.append(arom)
        charges.append(0)
        if prev >= 0:
            o = 1.5 if (arom and aromatic_flags[prev]) else pending
            bonds.append((prev, idx))
            orders.append(o)
        prev = idx
        pending = 1.0
        i += 1
    # implicit hydrogens by standard valence (organic subset)
    _VAL = {"C": 4, "N": 3, "O": 2, "S": 2, "P": 3, "B": 3,
            "F": 1, "Cl": 1, "Br": 1, "I": 1}
    order_sum = [0.0] * len(elements)
    explicit_h = [False] * len(elements)
    for (a, b), o in zip(bonds, orders):
        order_sum[a] += o
        order_sum[b] += o
        if elements[b] == "H":
            explicit_h[a] = True
        if elements[a] == "H":
            explicit_h[b] = True
    n0 = len(elements)
    for i in range(n0):
        e = elements[i]
        if e == "H" or e not in _VAL or explicit_h[i]:
            continue
        deficit = _VAL[e] + charges[i] - int(round(order_sum[i]))
        for _ in range(max(deficit, 0)):
            h = len(elements)
            elements.append("H")
            charges.append(0)
            bonds.append((i, h))
            orders.append(1.0)
    mol = MoleculeCommon(
        elements=elements, positions=np.zeros((len(elements), 3)),
        bonds=bonds, bond_orders=orders, formal_charges=charges,
        name=smiles)
    # real 3D geometry (force-directed embedding; consumers polish with
    # the force field)
    from .embed import ensure_coordinates
    return ensure_coordinates(mol)
