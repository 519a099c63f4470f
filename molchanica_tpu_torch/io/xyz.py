"""XYZ reader/writer.

Copy of molchanica_tpu.io.xyz:
the same host code, so its results equal the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..molecules.common import MoleculeCommon


def read_xyz(path) -> MoleculeCommon:
    lines = open(path).read().splitlines()
    n = int(lines[0].split()[0])
    name = lines[1].strip() if len(lines) > 1 else ""
    elements, pos = [], []
    for l in lines[2:2 + n]:
        p = l.split()
        elements.append(p[0])
        pos.append([float(p[1]), float(p[2]), float(p[3])])
    return MoleculeCommon(elements=elements, positions=np.asarray(pos),
                          name=name)


def write_xyz(mol: MoleculeCommon, path=None, comment="") -> str:
    out = [str(mol.n_atoms), comment or mol.name]
    for e, (x, y, z) in zip(mol.elements, mol.positions):
        out.append(f"{e:<3s} {x:14.6f} {y:14.6f} {z:14.6f}")
    text = "\n".join(out) + "\n"
    if path:
        open(path, "w").write(text)
    return text
