"""SDF / MDL molfile (V2000) reader and writer.

Copy of molchanica_tpu.io.sdf:
the same host code, so its results equal the reference's bit for bit.

(reference: SDF open/save via bio_files, src/file_io/mod.rs:114+ and export
at src/molecules/mod.rs:232-304)
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

from ..molecules.common import MoleculeCommon

_ORDER = {1: 1.0, 2: 2.0, 3: 3.0, 4: 1.5}
_ORDER_OUT = {1.0: 1, 2.0: 2, 3.0: 3, 1.5: 4}


def _read_block(lines: List[str]) -> MoleculeCommon:
    name = lines[0].strip()
    counts = lines[3]
    na = int(counts[0:3])
    nb = int(counts[3:6])
    elements, pos, fcs = [], [], []
    for i in range(na):
        l = lines[4 + i]
        pos.append([float(l[0:10]), float(l[10:20]), float(l[20:30])])
        elements.append(l[31:34].strip())
        chg_code = int(l[36:39]) if len(l) >= 39 and l[36:39].strip() else 0
        fcs.append({1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}.get(chg_code, 0))
    bonds, orders = [], []
    for i in range(nb):
        l = lines[4 + na + i]
        a = int(l[0:3]) - 1
        b = int(l[3:6]) - 1
        o = int(l[6:9])
        bonds.append((a, b))
        orders.append(_ORDER.get(o, 1.0))
    # M  CHG overrides
    for l in lines[4 + na + nb:]:
        if l.startswith("M  CHG"):
            parts = l.split()
            k = int(parts[2])
            for c in range(k):
                fcs[int(parts[3 + 2 * c]) - 1] = int(parts[4 + 2 * c])
        if l.startswith("M  END"):
            break
    return MoleculeCommon(
        elements=elements, positions=np.asarray(pos), bonds=bonds,
        bond_orders=orders, formal_charges=fcs, name=name)


def read_sdf(path) -> Union[MoleculeCommon, List[MoleculeCommon]]:
    """Read an SDF; returns one molecule or a list for multi-record files."""
    text = open(path).read()
    mols = []
    for chunk in text.split("$$$$"):
        lines = chunk.strip("\n").splitlines()
        if len(lines) >= 4 and len(lines[3]) >= 6:
            try:
                mols.append(_read_block(lines))
            except (ValueError, IndexError):
                continue
    if not mols:
        raise ValueError(f"no molecules parsed from {path}")
    return mols[0] if len(mols) == 1 else mols


def write_sdf(mol: MoleculeCommon, path=None) -> str:
    lines = [mol.name or "molchanica_tpu", "  molchanica-tpu", ""]
    na, nb = mol.n_atoms, len(mol.bonds)
    lines.append(f"{na:3d}{nb:3d}  0  0  0  0  0  0  0  0999 V2000")
    for i in range(na):
        x, y, z = mol.positions[i]
        lines.append(
            f"{x:10.4f}{y:10.4f}{z:10.4f} {mol.elements[i]:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    orders = mol.bond_orders or [1.0] * nb
    for (a, b), o in zip(mol.bonds, orders):
        lines.append(f"{a + 1:3d}{b + 1:3d}{_ORDER_OUT.get(o, 1):3d}  0  0  0  0")
    fcs = mol.formal_charges or []
    chg = [(i + 1, c) for i, c in enumerate(fcs) if c]
    if chg:
        lines.append("M  CHG" + f"{len(chg):3d}" +
                     "".join(f"{i:4d}{c:4d}" for i, c in chg))
    lines.append("M  END")
    lines.append("$$$$")
    out = "\n".join(lines) + "\n"
    if path:
        open(path, "w").write(out)
    return out
