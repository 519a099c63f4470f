"""MolCharacterization: rings, flexibility, functional groups, descriptors.

Copy of molchanica_tpu.molecules.characterization:
the same host code, so its results equal the reference's bit for bit.

Reference: `MolCharacterization` (src/properties/mol_characterization.rs:22):
rings/ring systems, rotatable bonds, flexibility, functional groups, H-bond
donors/acceptors, fCsp3, Ertl TPSA, cLogP (Crippen-style), molar
refractivity, Wiener index. Feature source for the ADME models and
pharmacophores.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .common import MoleculeCommon
from .elements import ELEMENT_MASSES


# --- Crippen-style atomic logP / molar-refractivity contributions
# (coarse-grained public-literature values keyed by element/context) ---
_CRIPPEN = {
    ("C", "aliphatic"): (0.14, 2.50),
    ("C", "aromatic"): (0.29, 3.00),
    ("C", "polar"): (-0.03, 2.75),   # C bonded to N/O
    ("N", "amine"): (-1.02, 2.26),
    ("N", "amide"): (-0.60, 2.40),
    ("N", "aromatic"): (-0.53, 2.50),
    ("O", "hydroxyl"): (-0.44, 1.00),
    ("O", "ether"): (-0.20, 1.20),
    ("O", "carbonyl"): (-0.12, 1.60),
    ("S", "any"): (0.65, 7.40),
    ("P", "any"): (0.86, 6.90),
    ("F", "any"): (0.22, 1.00),
    ("Cl", "any"): (0.66, 5.85),
    ("Br", "any"): (0.90, 8.75),
    ("I", "any"): (1.20, 13.9),
    ("H", "any"): (0.12, 1.06),
}

# Ertl TPSA fragment contributions (A^2) — the standard published table,
# keyed by (element, n_heavy_neighbors, n_hydrogens, aromatic, charge_hint)
_TPSA_N = {
    (1, 2, False): 26.02,   # N with 1 heavy nbr, 2 H (primary amine)
    (2, 1, False): 12.03,   # secondary amine
    (3, 0, False): 3.24,    # tertiary amine
    (2, 0, True): 12.89,    # aromatic N
    (2, 1, True): 15.79,    # aromatic NH
    (1, 1, False): 23.85,   # =NH imine-ish
    (2, 0, False): 12.36,   # =N- / nitrile-ish
}
_TPSA_O = {
    (1, 1, False): 20.23,   # hydroxyl
    (2, 0, False): 9.23,    # ether
    (1, 0, False): 17.07,   # carbonyl/=O
    (2, 0, True): 13.14,    # aromatic O
}


@dataclass
class FunctionalGroups:
    amine: int = 0
    amide: int = 0
    carboxylic_acid: int = 0
    ester: int = 0
    carbonyl: int = 0
    hydroxyl: int = 0
    ether: int = 0
    thiol: int = 0
    sulfide: int = 0
    nitrile: int = 0
    nitro: int = 0
    halogen: int = 0
    aromatic_ring: int = 0
    # census depth matching the reference FunctionalGroups fields
    # (mol_characterization.rs:48-77)
    pyridine_n: int = 0         # aromatic N, lone pair NOT in the sextet
    pyrrole_nh: int = 0         # aromatic N-H, lone pair IN the sextet
    imine: int = 0              # non-aromatic C=N nitrogen
    carboxylate: int = 0        # C with two H-free terminal oxygens
    sulfonamide: int = 0        # N on one sulfonyl S (R-SO2-N)
    sulfonimide: int = 0        # N between two sulfonyl S
    hydrophobic_carbon: int = 0  # C with only C/H neighbors
    fluorine: int = 0
    chlorine: int = 0
    bromine: int = 0
    iodine: int = 0


@dataclass
class MolCharacterization:
    n_atoms: int
    n_heavy: int
    mol_weight: float
    rings: List[List[int]] = field(default_factory=list)
    n_ring_systems: int = 0
    n_aromatic_rings: int = 0
    rotatable_bonds: List[Tuple[int, int]] = field(default_factory=list)
    flexibility: float = 0.0          # rotatable / heavy bonds
    h_bond_donors: int = 0
    h_bond_acceptors: int = 0
    f_csp3: float = 0.0
    tpsa: float = 0.0                 # Ertl topological PSA (A^2)
    clogp: float = 0.0                # Crippen-style
    molar_refractivity: float = 0.0
    wiener_index: int = 0
    bertz_ct: float = 0.0             # Bertz-style complexity index
    functional_groups: FunctionalGroups = field(
        default_factory=FunctionalGroups)
    formal_charge: int = 0

    def feature_vector(self) -> np.ndarray:
        """Whole-molecule descriptor vector (the reference's MLP feature
        source, src/therapeutic/mlp.rs)."""
        fg = self.functional_groups
        return np.asarray([
            self.n_atoms, self.n_heavy, self.mol_weight / 100.0,
            len(self.rings), self.n_ring_systems, self.n_aromatic_rings,
            len(self.rotatable_bonds), self.flexibility,
            self.h_bond_donors, self.h_bond_acceptors, self.f_csp3,
            self.tpsa / 10.0, self.clogp, self.molar_refractivity / 10.0,
            np.log1p(self.wiener_index),
            fg.amine, fg.amide, fg.carboxylic_acid, fg.ester, fg.carbonyl,
            fg.hydroxyl, fg.ether, fg.thiol, fg.sulfide, fg.nitrile,
            fg.nitro, fg.halogen, self.formal_charge,
            # round-3 census depth (mirrors the reference field set)
            np.log1p(self.bertz_ct),
            fg.pyridine_n, fg.pyrrole_nh, fg.imine, fg.carboxylate,
            fg.sulfonamide, fg.sulfonimide, fg.hydrophobic_carbon,
            fg.fluorine, fg.chlorine, fg.bromine, fg.iodine,
        ], np.float32)


FEATURE_DIM = 40


def find_rings(n: int, bonds: Sequence[Tuple[int, int]],
               max_size: int = 8) -> List[List[int]]:
    """Smallest set of smallest rings (approximate: cycle basis via BFS)."""
    adj: List[List[int]] = [[] for _ in range(n)]
    for i, j in bonds:
        adj[i].append(j)
        adj[j].append(i)
    rings: List[List[int]] = []
    seen: Set[frozenset] = set()
    for (a, b) in bonds:
        # shortest path a..b avoiding the direct edge -> smallest ring
        # containing this bond
        prev = {a: None}
        queue = [a]
        found = None
        while queue and found is None:
            nxt = []
            for u in queue:
                for v in adj[u]:
                    if u == a and v == b:
                        continue
                    if v not in prev:
                        prev[v] = u
                        if v == b:
                            found = v
                            break
                        nxt.append(v)
                if found:
                    break
            queue = nxt
        if found is None:
            continue
        path = [b]
        while path[-1] is not None:
            p = prev[path[-1]]
            path.append(p)
        path.pop()
        if len(path) <= max_size:
            key = frozenset(path)
            if key not in seen:
                seen.add(key)
                rings.append(sorted(path))
    return rings


def _ring_systems(rings: List[List[int]]) -> int:
    systems: List[Set[int]] = []
    for r in rings:
        rs = set(r)
        merged = None
        for s in systems:
            if s & rs:
                s |= rs
                merged = s
                break
        if merged is None:
            systems.append(rs)
    # merge transitively
    changed = True
    while changed:
        changed = False
        for i in range(len(systems)):
            for j in range(i + 1, len(systems)):
                if systems[i] & systems[j]:
                    systems[i] |= systems.pop(j)
                    changed = True
                    break
            if changed:
                break
    return len(systems)


def find_rotatable_bonds(elements, bonds, bond_orders, rings,
                         adj) -> List[Tuple[int, int]]:
    """Single acyclic bonds between non-terminal heavy atoms (reference
    src/molecules/rotatable_bonds.rs)."""
    ring_bonds = set()
    for r in rings:
        rs = set(r)
        for i, j in bonds:
            if i in rs and j in rs:
                ring_bonds.add((min(i, j), max(i, j)))
    out = []
    el = [e.capitalize() for e in elements]
    for bi, (i, j) in enumerate(bonds):
        o = 1.0 if bond_orders is None else bond_orders[bi]
        if o != 1.0:
            continue
        if (min(i, j), max(i, j)) in ring_bonds:
            continue
        if el[i] == "H" or el[j] == "H":
            continue
        heavy_i = sum(1 for k in adj[i] if el[k] != "H")
        heavy_j = sum(1 for k in adj[j] if el[k] != "H")
        if heavy_i >= 2 and heavy_j >= 2:
            out.append((i, j))
    return out


def characterize(mol: MoleculeCommon) -> MolCharacterization:
    el = [e.capitalize() for e in mol.elements]
    n = len(el)
    adj = mol.adjacency()
    orders = mol.bond_orders
    order_of = {}
    for bi, (i, j) in enumerate(mol.bonds):
        o = 1.0 if orders is None else float(orders[bi])
        order_of[(i, j)] = order_of[(j, i)] = o

    heavy = [i for i in range(n) if el[i] != "H"]
    mw = sum(ELEMENT_MASSES.get(e, 0.0) for e in el)
    rings = find_rings(n, mol.bonds)
    aromatic_atoms: Set[int] = set()
    n_arom = 0
    for r in rings:
        if len(r) in (5, 6) and all(
                el[i] in ("C", "N", "O", "S") and len(adj[i]) <= 3
                for i in r):
            ring_orders = [order_of.get((r[k], r[(k + 1) % len(r)]), 0)
                           for k in range(len(r))]
            if orders is not None:
                arom = all(abs(order_of.get((i, j), 1.0) - 1.5) < 0.01
                           for i in r for j in adj[i] if j in r)
            else:
                arom = len(r) == 6 and all(el[i] == "C" for i in r)
            if arom:
                n_arom += 1
                aromatic_atoms |= set(r)

    rot = find_rotatable_bonds(el, mol.bonds, orders, rings, adj)
    heavy_bonds = [b for b in mol.bonds
                   if el[b[0]] != "H" and el[b[1]] != "H"]
    flexibility = len(rot) / max(len(heavy_bonds), 1)

    def n_h(i):
        return sum(1 for k in adj[i] if el[k] == "H")

    def heavy_nbrs(i):
        return [k for k in adj[i] if el[k] != "H"]

    # H-bond donors/acceptors (Lipinski-style)
    donors = sum(1 for i in range(n)
                 if el[i] in ("N", "O") and n_h(i) > 0)
    acceptors = sum(1 for i in range(n) if el[i] in ("N", "O"))

    # fCsp3
    carbons = [i for i in range(n) if el[i] == "C"]
    sp3 = [i for i in carbons
           if i not in aromatic_atoms
           and all(order_of.get((i, j), 1.0) == 1.0 for j in adj[i])]
    f_csp3 = len(sp3) / max(len(carbons), 1)

    # TPSA
    tpsa = 0.0
    for i in range(n):
        hn = len(heavy_nbrs(i))
        hh = n_h(i)
        ar = i in aromatic_atoms
        if el[i] == "N":
            tpsa += _TPSA_N.get((hn, hh, ar),
                                _TPSA_N.get((hn, hh, False), 11.68))
        elif el[i] == "O":
            tpsa += _TPSA_O.get((hn, hh, ar),
                                _TPSA_O.get((hn, hh, False), 14.0))
        elif el[i] == "S" and (hh or hn <= 2):
            tpsa += 25.30 if hh else 12.0 if hn <= 2 else 0.0

    # cLogP + molar refractivity (Crippen-style coarse classes)
    clogp = 0.0
    mr = 0.0
    for i in range(n):
        e = el[i]
        if e == "C":
            if i in aromatic_atoms:
                key = ("C", "aromatic")
            elif any(el[j] in ("N", "O") for j in adj[i]):
                key = ("C", "polar")
            else:
                key = ("C", "aliphatic")
        elif e == "N":
            if any(el[j] == "C" and any(
                    el[k] == "O" and order_of.get((j, k), 1) >= 2
                    for k in adj[j]) for j in adj[i]):
                key = ("N", "amide")
            elif i in aromatic_atoms:
                key = ("N", "aromatic")
            else:
                key = ("N", "amine")
        elif e == "O":
            if n_h(i):
                key = ("O", "hydroxyl")
            elif any(order_of.get((i, j), 1) >= 2 for j in adj[i]) \
                    or len(heavy_nbrs(i)) == 1:
                key = ("O", "carbonyl")
            else:
                key = ("O", "ether")
        elif e in ("S", "P", "F", "Cl", "Br", "I", "H"):
            key = (e, "any")
        else:
            key = None
        if key and key in _CRIPPEN:
            lp, m = _CRIPPEN[key]
            clogp += lp
            mr += m

    # Wiener index over heavy atoms (sum of shortest-path distances)
    wiener = 0
    hidx = {a: k for k, a in enumerate(heavy)}
    for s in heavy:
        dist = {s: 0}
        queue = [s]
        while queue:
            nxt = []
            for u in queue:
                for v in adj[u]:
                    if el[v] != "H" and v not in dist:
                        dist[v] = dist[u] + 1
                        nxt.append(v)
            queue = nxt
        wiener += sum(d for a, d in dist.items() if hidx.get(a, -1) >
                      hidx[s])

    fg = FunctionalGroups()
    fg.aromatic_ring = n_arom
    for i in range(n):
        e = el[i]
        if e == "N":
            if any(el[j] == "C" and any(
                    el[k] == "O" and order_of.get((j, k), 1) >= 2
                    for k in adj[j]) for j in adj[i]):
                fg.amide += 1
            elif i not in aromatic_atoms and n_h(i) > 0:
                fg.amine += 1
        elif e == "O" and n_h(i):
            c_nb = [j for j in heavy_nbrs(i) if el[j] == "C"]
            if c_nb and any(el[k] == "O" and order_of.get((c_nb[0], k), 1) >= 2
                            for k in adj[c_nb[0]]):
                fg.carboxylic_acid += 1
            else:
                fg.hydroxyl += 1
        elif e == "O" and not n_h(i):
            hn = heavy_nbrs(i)
            if len(hn) == 2:
                if any(el[k] == "O" and order_of.get((j, k), 1) >= 2
                       for j in hn for k in adj[j]):
                    fg.ester += 1
                else:
                    fg.ether += 1
            elif len(hn) == 1 and order_of.get((i, hn[0]), 1) >= 2:
                fg.carbonyl += 1
        elif e == "S":
            if n_h(i):
                fg.thiol += 1
            elif len(heavy_nbrs(i)) == 2:
                fg.sulfide += 1
        elif e == "C":
            if any(el[j] == "N" and order_of.get((i, j), 1) >= 3
                   for j in adj[i]):
                fg.nitrile += 1
        if e in ("F", "Cl", "Br", "I"):
            fg.halogen += 1
    nitro_n = [i for i in range(n) if el[i] == "N"
               and sum(1 for j in adj[i] if el[j] == "O"
                       and len(heavy_nbrs(j)) == 1) >= 2]
    fg.nitro = len(nitro_n)

    # --- census depth (reference mol_characterization.rs:48-77) ---
    def is_sulfonyl_s(s):
        return el[s] == "S" and sum(
            1 for k in adj[s]
            if el[k] == "O" and order_of.get((s, k), 1) >= 2) >= 2

    for i in range(n):
        e = el[i]
        if e == "N":
            if i in aromatic_atoms:
                if n_h(i) > 0:
                    fg.pyrrole_nh += 1
                elif len(heavy_nbrs(i)) == 2:
                    fg.pyridine_n += 1
            else:
                if any(el[j] == "C" and order_of.get((i, j), 1) >= 2
                       for j in adj[i]):
                    fg.imine += 1
                s_sulfonyl = sum(1 for j in heavy_nbrs(i)
                                 if is_sulfonyl_s(j)
                                 and order_of.get((i, j), 1) == 1.0)
                if s_sulfonyl >= 2:
                    fg.sulfonimide += 1
                elif s_sulfonyl == 1:
                    fg.sulfonamide += 1
        elif e == "C":
            term_o = [j for j in adj[i]
                      if el[j] == "O" and len(heavy_nbrs(j)) == 1]
            if (len(term_o) == 2 and all(n_h(j) == 0 for j in term_o)
                    and any(order_of.get((i, j), 1) >= 1.5
                            for j in term_o)):
                fg.carboxylate += 1
            if adj[i] and all(el[j] in ("C", "H") for j in adj[i]):
                fg.hydrophobic_carbon += 1
        elif e == "F":
            fg.fluorine += 1
        elif e == "Cl":
            fg.chlorine += 1
        elif e == "Br":
            fg.bromine += 1
        elif e == "I":
            fg.iodine += 1

    # Bertz-style complexity: first-order information content of the
    # heavy-atom connectivity multigraph (reference bertz_ct,
    # mol_characterization.rs:1919): 2 B log2 B - sum_k b_k log2 b_k over
    # bond equivalence classes keyed by (element, degree) endpoints.
    import math as _math
    classes = {}
    b_total = 0
    for (i, j) in heavy_bonds:
        o = order_of.get((i, j), 1.0)
        key = tuple(sorted([(el[i], len(heavy_nbrs(i))),
                            (el[j], len(heavy_nbrs(j)))])) + (o,)
        classes[key] = classes.get(key, 0) + 1
        b_total += 1
    if b_total:
        bertz = 2.0 * b_total * _math.log2(b_total) - sum(
            c * _math.log2(c) for c in classes.values() if c > 0)
    else:
        bertz = 0.0

    formal = int(sum(mol.formal_charges)) if mol.formal_charges else 0

    return MolCharacterization(
        n_atoms=n, n_heavy=len(heavy), mol_weight=mw, rings=rings,
        n_ring_systems=_ring_systems(rings), n_aromatic_rings=n_arom,
        rotatable_bonds=rot, flexibility=flexibility,
        h_bond_donors=donors, h_bond_acceptors=acceptors, f_csp3=f_csp3,
        tpsa=tpsa, clogp=clogp, molar_refractivity=mr,
        wiener_index=wiener, bertz_ct=bertz, functional_groups=fg,
        formal_charge=formal)
