"""GAFF2 atom typing from element + connectivity (Antechamber-style).

Copy of molchanica_tpu.ff.typing_gaff:
the same host code, so its results equal the reference's bit for bit.

Reference surface: `find_ff_types` ("GAFF2 atom-typing a la Antechamber",
SURVEY.md §2.1; consumed by the reference at src/md/mod.rs via the dynamics
crate). This implements the Antechamber decision structure for the GAFF
type system:

- pure-aromatic 6-rings (Kekulé- or 1.5-order-detected): ca / nb (pyridine)
  / na (pyridinium-like 3-connected ring N), with the biphenyl bridge
  split cp;
- conjugated ring systems (5-rings like imidazole/pyrrole/furan/thiophene,
  quinoid rings, fused non-aromatic sp2 rings): the alternating inner-sp2
  splits cc/cd (C) and nc/nd (N), letter-alternated across double bonds so
  cc-cc parametrizes as single-ish and cc-cd as double-ish, exactly the
  role the split plays in GAFF;
- conjugated chains: ce/cf (inner sp2 C), cg/ch (inner sp1 C), ne/nf
  (inner sp2 N), with terminal sp2/sp1 atoms staying c2/c1/n2;
- small-ring strain splits: cx/cy (sp3 C in 3-/4-rings), cu/cv (sp2 C in
  3-/4-rings);
- the H electron-withdrawal ladder hc/h1/h2/h3 and the aromatic h4/h5.

Types absent from the embedded parameter subset degrade gracefully: the
GAFF_PARENT fold (used by ff.params.assign_params on lookup miss) maps each
split to its parametrized parent class, so typing fidelity never costs a
MissingParameter for mainstream chemistry.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# Parameter-fold parents: when a bond/angle/dihedral/LJ lookup misses with
# the exact types, ff.params retries with these (conjugation splits share
# their parent's parameters to first order; Antechamber's own gaff2.dat
# carries distinct values — load one via ff.parse_dat for full fidelity).
GAFF_PARENT: Dict[str, str] = {
    "cc": "ca", "cd": "ca", "cp": "ca", "cq": "ca",
    "ce": "c2", "cf": "c2", "cu": "c2", "cv": "c2",
    "cg": "c1", "ch": "c1",
    "cx": "c3", "cy": "c3",
    "nb": "n2", "nc": "n2", "nd": "n2", "ne": "n2", "nf": "n2",
    "pb": "p5", "pc": "p5", "pd": "p5",
    "sx": "s4", "sy": "s6",
    "h5": "h4",
}


def fold_type(t: str) -> str:
    return GAFF_PARENT.get(t, t)


def _rings(n_atoms: int, adj: List[List[int]], max_size: int = 7):
    """Small-ring perception: for every bond, the shortest cycle through it
    (BFS with the bond removed). Returns unique rings (frozensets) plus
    per-atom membership and smallest-ring size."""
    rings = set()
    for a in range(n_atoms):
        for b in adj[a]:
            if b < a:
                continue
            # shortest path a..b avoiding the (a, b) edge
            prev = {a: -1}
            queue = [a]
            found = None
            while queue and found is None:
                nxt = []
                for u in queue:
                    for w in adj[u]:
                        if u == a and w == b:
                            continue
                        if w not in prev:
                            prev[w] = u
                            if w == b:
                                found = w
                                break
                            nxt.append(w)
                    if found is not None:
                        break
                queue = nxt
            if found is None:
                continue
            path = [b]
            while path[-1] != a:
                path.append(prev[path[-1]])
            if len(path) <= max_size:
                rings.add(frozenset(path))
    in_ring = [False] * n_atoms
    ring_size = [0] * n_atoms
    for r in rings:
        for i in r:
            in_ring[i] = True
            if ring_size[i] == 0 or len(r) < ring_size[i]:
                ring_size[i] = len(r)
    return sorted(rings, key=lambda r: (len(r), sorted(r))), \
        in_ring, ring_size


def assign_gaff_types(
    elements: Sequence[str],
    bonds: Sequence[Tuple[int, int]],
    bond_orders: Sequence[float] = None,
) -> List[str]:
    """Assign GAFF-family types. bond_orders: 1/2/3/1.5 per bond (defaults
    to 1 everywhere, with aromaticity inferred from 6-rings of sp2 carbon
    when orders are absent; the conjugation splits need explicit orders)."""
    n = len(elements)
    adj: List[List[int]] = [[] for _ in range(n)]
    order_of = {}
    for bi, (i, j) in enumerate(bonds):
        adj[i].append(j)
        adj[j].append(i)
        o = 1.0 if bond_orders is None else float(bond_orders[bi])
        order_of[(i, j)] = order_of[(j, i)] = o

    el = [e.capitalize() for e in elements]
    deg = [len(a) for a in adj]
    rings, in_ring, ring_size = _rings(n, adj)

    def max_order(i):
        return max((order_of[(i, j)] for j in adj[i]), default=1.0)

    def has_nb_el(i, symbol, min_order=0.0):
        return any(el[j] == symbol and order_of[(i, j)] >= min_order
                   for j in adj[i])

    # ---- pure-aromatic 6-ring perception -------------------------------
    # A 6-ring is aromatic when its ring bonds are all order 1.5, or form
    # an alternating Kekulé 1/2 pattern, with members restricted to C and
    # 2-ring-connected N (pyridine-like). Without bond orders, fall back to
    # the degree heuristic (all-C sp2-shaped rings).
    aromatic_atom = [False] * n
    for r in rings:
        if len(r) != 6:
            continue
        members = sorted(r)
        ok_members = all(
            el[i] == "C" or
            (el[i] == "N" and sum(1 for j in adj[i] if j in r) == 2)
            for i in members)
        if not ok_members:
            continue
        # walk the cycle in order
        start = members[0]
        ring_adj = {i: [j for j in adj[i] if j in r] for i in members}
        if any(len(v) != 2 for v in ring_adj.values()):
            continue   # fused pathological case: skip, handled per-ring
        cyc = [start, ring_adj[start][0]]
        while len(cyc) < 6:
            a, b = cyc[-2], cyc[-1]
            nxt = ring_adj[b][0] if ring_adj[b][0] != a else ring_adj[b][1]
            cyc.append(nxt)
        cyc_orders = [order_of[(cyc[k], cyc[(k + 1) % 6])] for k in range(6)]
        if bond_orders is not None:
            if all(abs(o - 1.5) < 0.01 for o in cyc_orders):
                arom = True
            else:
                pat = [2.0 if o >= 1.9 else 1.0 for o in cyc_orders]
                arom = (pat == [2, 1, 2, 1, 2, 1] or
                        pat == [1, 2, 1, 2, 1, 2])
                # every C member must carry its ring double bond (quinoid
                # rings with exocyclic C=O fail the alternation test above)
        else:
            arom = all(el[i] == "C" and deg[i] == 3 for i in members) or \
                all(deg[i] <= 3 for i in members) and \
                all(el[i] == "C" for i in members) and \
                all(in_ring[i] for i in members)
            arom = arom and all(deg[i] == 3 or el[i] == "N" for i in members)
        if arom:
            for i in members:
                aromatic_atom[i] = True

    def aromatic(i):
        if aromatic_atom[i]:
            return True
        if any(abs(order_of[(i, j)] - 1.5) < 0.01 for j in adj[i]):
            return True
        return False

    types = [""] * n
    # ---- pass 1: heavy atoms -------------------------------------------
    for i in range(n):
        e = el[i]
        if e == "C":
            if aromatic(i):
                types[i] = "ca"
            elif max_order(i) >= 3.0 or (deg[i] == 2 and max_order(i) >= 2.0
                                         and all(order_of[(i, j)] >= 2.0
                                                 for j in adj[i])):
                types[i] = "c1"
            elif has_nb_el(i, "O", 2.0) or has_nb_el(i, "S", 2.0):
                types[i] = "c"     # carbonyl / thiocarbonyl carbon
            elif max_order(i) >= 2.0:
                if in_ring[i] and ring_size[i] == 3:
                    types[i] = "cu"    # sp2 C in 3-ring
                elif in_ring[i] and ring_size[i] == 4:
                    types[i] = "cv"    # sp2 C in 4-ring
                else:
                    types[i] = "c2"
            elif in_ring[i] and ring_size[i] == 3:
                types[i] = "cx"    # sp3 C in 3-ring
            elif in_ring[i] and ring_size[i] == 4:
                types[i] = "cy"    # sp3 C in 4-ring
            else:
                types[i] = "c3"
        elif e == "N":
            if aromatic(i):
                # pyridine-type (2 ring bonds, no 3rd substituent) = nb;
                # 3-connected aromatic N (N-oxide / pyridinium / fused
                # bridgehead) = na
                types[i] = "nb" if deg[i] == 2 else "na"
            elif max_order(i) >= 3.0:
                types[i] = "n1"
            elif any(el[j] == "O" and order_of[(i, j)] >= 2.0
                     for j in adj[i]) \
                    and sum(el[j] == "O" for j in adj[i]) >= 2:
                types[i] = "no"    # nitro (before the generic sp2 branch)
            elif max_order(i) >= 2.0:
                types[i] = "n2"
            elif deg[i] == 4:
                types[i] = "n4"
            elif in_ring[i] and ring_size[i] == 5 and deg[i] == 3 \
                    and bond_orders is not None and any(
                        max_order(j) >= 1.5 and j in
                        next((r for r in rings if i in r), frozenset())
                        for j in adj[i]):
                types[i] = "na"    # pyrrole/imidazole N-H (conjugated ring)
            elif any(el[j] == "C" and (has_nb_el(j, "O", 2.0)
                                       or has_nb_el(j, "S", 2.0))
                     for j in adj[i]):
                types[i] = "n"     # amide
            elif any(aromatic(j) for j in adj[i]):
                types[i] = "nh"    # aniline-type
            elif any(el[j] == "O" and order_of[(i, j)] >= 2.0
                     for j in adj[i]) \
                    and sum(el[j] == "O" for j in adj[i]) >= 2:
                types[i] = "no"    # nitro
            else:
                types[i] = "n3"    # amine
        elif e == "O":
            if max_order(i) >= 2.0 or deg[i] == 1 and any(
                    el[j] in ("C", "N", "P", "S") and deg[j] >= 3
                    and sum(el[k] == "O" and deg[k] == 1 for k in adj[j]) >= 2
                    for j in adj[i]):
                types[i] = "o"     # carbonyl / oxo / carboxylate
            elif any(el[j] == "H" for j in adj[i]):
                types[i] = "oh"
            elif deg[i] == 1:
                types[i] = "o"
            else:
                types[i] = "os"
        elif e == "S":
            if max_order(i) >= 2.0 and deg[i] <= 1:
                types[i] = "s2"
            elif deg[i] == 4 or sum(el[j] == "O" and deg[j] == 1
                                    for j in adj[i]) >= 2:
                types[i] = "s6"    # sulfone/sulfate
            elif deg[i] == 3:
                types[i] = "s4"    # sulfoxide
            elif any(el[j] == "H" for j in adj[i]):
                types[i] = "sh"
            else:
                types[i] = "ss"
        elif e == "P":
            types[i] = "p5"
        elif e in ("F", "Cl", "Br", "I"):
            types[i] = e.lower()
        elif e == "H":
            pass   # second pass
        else:
            types[i] = e.lower()

    # ---- conjugation splits (need explicit bond orders) ----------------
    if bond_orders is not None:
        _apply_conjugation_splits(
            n, el, adj, order_of, rings, in_ring, ring_size, types)

    # ---- pass 2: hydrogens by attached heavy atom + EW count -----------
    for i in range(n):
        if el[i] != "H":
            continue
        if not adj[i]:
            types[i] = "hc"
            continue
        j = adj[i][0]
        ej = el[j]
        if ej == "O":
            types[i] = "ho"
        elif ej == "N":
            types[i] = "hn"
        elif ej == "S":
            types[i] = "hs"
        elif ej == "P":
            types[i] = "hp"
        elif ej == "C":
            ew = sum(1 for k in adj[j]
                     if el[k] in ("N", "O", "F", "Cl", "Br", "S"))
            if types[j] in ("ca", "cc", "cd", "cp", "cq", "cu", "cv"):
                # aromatic/conjugated-sp2 H ladder: ha / h4 / h5
                types[i] = {0: "ha", 1: "h4"}.get(ew, "h5")
            elif types[j] in ("c2", "c1", "ce", "cf", "cg", "ch", "c"):
                types[i] = "ha" if ew == 0 else "h4"
            else:
                types[i] = {0: "hc", 1: "h1", 2: "h2", 3: "h3"}.get(ew, "h3")
        else:
            types[i] = "hc"
    return types


def _apply_conjugation_splits(n, el, adj, order_of, rings, in_ring,
                              ring_size, types):
    """Retype inner-conjugated sp2/sp1 atoms with the alternating GAFF
    splits. An atom is INNER-conjugated when it carries a multiple bond
    AND has a single bond to another multiple-bond-bearing heavy atom
    (the single bond is the conjugation link). Letters alternate across
    multiple bonds (cc=cd means the bond is double-ish) and stay equal
    across single bonds — assigned by BFS over each conjugated component,
    seeded at its lowest atom index for determinism."""
    def has_multi(i):
        return any(order_of[(i, j)] >= 1.5 for j in adj[i])

    atom_rings0 = [set() for _ in range(n)]
    for ri, r in enumerate(rings):
        for i in r:
            atom_rings0[i].add(ri)

    def conj_donor(i, j):
        """Does neighbor j extend i's conjugation across the (i, j) single
        bond? Multiple-bond carriers and carbonyls do; so do in-ring
        lone-pair donors (pyrrole/imidazole na, furan os, thiophene ss) —
        the alpha carbons of those rings are cc/cd in GAFF."""
        if has_multi(j) or types[j] in ("c", "ca", "cp", "no"):
            return True
        if types[j] in ("na", "os", "ss", "n") \
                and (atom_rings0[i] & atom_rings0[j]):
            return True
        return False

    # candidates: non-aromatic sp2 C (c2), sp1 C (c1), sp2 N (n2). The
    # strained-ring sp2 types cu (3-ring) / cv (4-ring) keep their strain
    # type (they are not an alternation pair).
    cand = set()
    for i in range(n):
        if types[i] not in ("c2", "c1", "n2"):
            continue
        if not has_multi(i):
            continue
        linked = any(order_of[(i, j)] < 1.5 and el[j] != "H"
                     and conj_donor(i, j) for j in adj[i])
        if linked:
            cand.add(i)

    # biphenyl bridge: aromatic C single-bonded to an aromatic C in a
    # DIFFERENT ring => cp, both sides (collect first: retyping one side
    # in place would hide the other side's ca neighbor)
    bridges = [i for i in range(n) if types[i] == "ca" and any(
        types[j] == "ca" and order_of[(i, j)] < 1.5
        and not (atom_rings0[i] & atom_rings0[j]) for j in adj[i])]
    for i in bridges:
        types[i] = "cp"

    if not cand:
        return

    # letter pairs per (element, ring-membership)
    def pair(i):
        if el[i] == "N":
            return ("nc", "nd") if in_ring[i] and ring_size[i] <= 6 \
                else ("ne", "nf")
        if types[i] == "c1":
            return ("cg", "ch")
        if in_ring[i] and ring_size[i] <= 6:
            return ("cc", "cd")
        return ("ce", "cf")

    assigned = {}
    for seed in sorted(cand):
        if seed in assigned:
            continue
        assigned[seed] = 0
        queue = [seed]
        while queue:
            u = queue.pop(0)
            for w in adj[u]:
                if w not in cand or w in assigned:
                    continue
                flip = order_of[(u, w)] >= 1.5
                assigned[w] = assigned[u] ^ (1 if flip else 0)
                queue.append(w)
    for i, parity in assigned.items():
        types[i] = pair(i)[parity]
