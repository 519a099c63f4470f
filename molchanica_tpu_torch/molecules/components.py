"""Molecular component decomposition: ring systems, linkers, substituents.

Copy of molchanica_tpu.molecules.components:
the same host code, so its results equal the reference's bit for bit.

Reference parity: the reference's molecule-component layer (SURVEY §2.3
"Mol components") — beyond the functional-group census in
characterization, this decomposes a molecule into connected components
after cutting acyclic single bonds between units (BRICS-flavoured):
ring systems stay intact, chains split at attachment points. Used by
fragment-based analysis and the mol editor surface.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Set, Tuple

import numpy as np

from .characterization import find_rings
from .common import MoleculeCommon


@dataclass
class Component:
    atom_indices: List[int]
    kind: str                        # "ring_system" | "linker" | "substituent"
    elements: List[str] = field(default_factory=list)
    attachment_points: List[int] = field(default_factory=list)

    @property
    def n_atoms(self) -> int:
        return len(self.atom_indices)


def _ring_systems(mol: MoleculeCommon) -> List[Set[int]]:
    rings = find_rings(mol.n_atoms, mol.bonds)
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
    # transitive merge
    changed = True
    while changed:
        changed = False
        for i in range(len(systems)):
            for j in range(i + 1, len(systems)):
                if systems[i] & systems[j]:
                    systems[i] |= systems[j]
                    del systems[j]
                    changed = True
                    break
            if changed:
                break
    return systems


def decompose(mol: MoleculeCommon) -> List[Component]:
    """Cut every acyclic bond between a ring atom and a non-ring atom
    (and between heteroatom-containing functional units), then report the
    connected components."""
    n = mol.n_atoms
    systems = _ring_systems(mol)
    in_ring = set().union(*systems) if systems else set()
    adj = mol.adjacency()

    cut: Set[Tuple[int, int]] = set()
    for a, b in mol.bonds:
        ra, rb = a in in_ring, b in in_ring
        if ra != rb:
            cut.add((min(a, b), max(a, b)))       # ring-chain boundary
        elif ra and rb:
            same = any(a in s and b in s for s in systems)
            if not same:
                cut.add((min(a, b), max(a, b)))   # biaryl-style link

    # connected components of the cut graph
    seen = [False] * n
    comps: List[Component] = []
    for start in range(n):
        if seen[start]:
            continue
        stack, members = [start], []
        seen[start] = True
        while stack:
            u = stack.pop()
            members.append(u)
            for v in adj[u]:
                if not seen[v] and (min(u, v), max(u, v)) not in cut:
                    seen[v] = True
                    stack.append(v)
        mset = set(members)
        attach = sorted(u for u in members
                        if any((min(u, v), max(u, v)) in cut
                               for v in adj[u]))
        if mset & in_ring:
            kind = "ring_system"
        elif len(attach) >= 2:
            kind = "linker"
        else:
            kind = "substituent"
        comps.append(Component(
            atom_indices=sorted(members), kind=kind,
            elements=[mol.elements[i] for i in sorted(members)],
            attachment_points=attach))
    return comps


def component_summary(mol: MoleculeCommon) -> dict:
    comps = decompose(mol)
    return {
        "n_components": len(comps),
        "n_ring_systems": sum(c.kind == "ring_system" for c in comps),
        "n_linkers": sum(c.kind == "linker" for c in comps),
        "n_substituents": sum(c.kind == "substituent" for c in comps),
        "largest_component": max((c.n_atoms for c in comps), default=0),
    }
