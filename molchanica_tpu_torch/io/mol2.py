"""Tripos MOL2 reader/writer (carries partial charges + SYBYL types).

Copy of molchanica_tpu.io.mol2:
the same host code, so its results equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..molecules.common import MoleculeCommon

_ORDER = {"1": 1.0, "2": 2.0, "3": 3.0, "ar": 1.5, "am": 1.0, "du": 1.0,
          "un": 1.0, "nc": 0.0}


def read_mol2(path) -> MoleculeCommon:
    lines = open(path).read().splitlines()
    section = None
    name = ""
    elements, pos, charges, names = [], [], [], []
    bonds, orders = [], []
    seen_mol_lines = 0
    for l in lines:
        s = l.strip()
        if s.startswith("@<TRIPOS>"):
            section = s[9:].upper()
            continue
        if not s or s.startswith("#"):
            continue
        if section == "MOLECULE":
            if seen_mol_lines == 0:
                name = s
            seen_mol_lines += 1
        elif section == "ATOM":
            p = s.split()
            names.append(p[1])
            pos.append([float(p[2]), float(p[3]), float(p[4])])
            elements.append(p[5].split(".")[0])
            charges.append(float(p[8]) if len(p) > 8 else 0.0)
        elif section == "BOND":
            p = s.split()
            bonds.append((int(p[1]) - 1, int(p[2]) - 1))
            orders.append(_ORDER.get(p[3].lower(), 1.0))
    return MoleculeCommon(
        elements=elements, positions=np.asarray(pos), bonds=bonds,
        bond_orders=orders, atom_names=names,
        charges=np.asarray(charges) if any(charges) else None, name=name)


def write_mol2(mol: MoleculeCommon, path=None) -> str:
    na, nb = mol.n_atoms, len(mol.bonds)
    out = ["@<TRIPOS>MOLECULE", mol.name or "molchanica_tpu",
           f"{na} {nb} 1 0 0", "SMALL",
           "USER_CHARGES" if mol.charges is not None else "NO_CHARGES", "",
           "@<TRIPOS>ATOM"]
    q = mol.charges if mol.charges is not None else np.zeros(na)
    names = mol.atom_names or [f"{e}{i+1}" for i, e in enumerate(mol.elements)]
    for i in range(na):
        x, y, z = mol.positions[i]
        out.append(f"{i+1:7d} {names[i]:<8s}{x:10.4f}{y:10.4f}{z:10.4f} "
                   f"{mol.elements[i]:<5s} 1  UNL1 {q[i]:10.4f}")
    out.append("@<TRIPOS>BOND")
    orders = mol.bond_orders or [1.0] * nb
    rev = {1.0: "1", 2.0: "2", 3.0: "3", 1.5: "ar"}
    for bi, ((a, b), o) in enumerate(zip(mol.bonds, orders)):
        out.append(f"{bi+1:6d}{a+1:6d}{b+1:6d} {rev.get(o, '1')}")
    text = "\n".join(out) + "\n"
    if path:
        open(path, "w").write(text)
    return text
