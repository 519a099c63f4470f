"""PDB reader/writer (ATOM/HETATM/CONECT subset).

Copy of molchanica_tpu.io.pdb:
the same host code, so its results equal the reference's bit for bit.

(reference: mmCIF is primary there via bio_files; PDB/PDBQT export at
src/molecules/mod.rs:232-304)
"""
from __future__ import annotations

import numpy as np

from ..molecules.common import MoleculeCommon
from ..molecules.elements import normalize_symbol


def read_pdb(path) -> MoleculeCommon:
    elements, pos, names, resn, resi, chains, het = [], [], [], [], [], [], []
    bonds = set()
    serial_to_idx = {}
    for l in open(path):
        rec = l[:6]
        if rec in ("ATOM  ", "HETATM"):
            serial = int(l[6:11])
            name = l[12:16].strip()
            elem = l[76:78].strip() if len(l) >= 78 and l[76:78].strip() \
                else "".join(c for c in name if c.isalpha())[:2]
            # strip digits; two-letter elements keep case info
            e = elem.strip()
            if len(e) == 2 and e[1].islower():
                pass
            elif len(e) >= 1:
                e = e[0]
            serial_to_idx[serial] = len(elements)
            elements.append(normalize_symbol(e))
            names.append(name)
            resn.append(l[17:20].strip())
            chains.append(l[21])
            resi.append(int(l[22:26]))
            pos.append([float(l[30:38]), float(l[38:46]), float(l[46:54])])
            het.append(rec == "HETATM")
        elif rec == "CONECT":
            fields = [l[6:11], l[11:16], l[16:21], l[21:26], l[26:31]]
            vals = [int(f) for f in fields if f.strip()]
            if vals:
                a = vals[0]
                for b in vals[1:]:
                    if a in serial_to_idx and b in serial_to_idx:
                        i, j = serial_to_idx[a], serial_to_idx[b]
                        bonds.add((min(i, j), max(i, j)))
    return MoleculeCommon(
        elements=elements, positions=np.asarray(pos), bonds=sorted(bonds),
        atom_names=names, res_names=resn, res_ids=resi, chains=chains,
        hetero=het, name=str(path))


def write_pdb(mol: MoleculeCommon, path=None) -> str:
    out = []
    names = mol.atom_names or [f"{e}{i+1}"[:4]
                               for i, e in enumerate(mol.elements)]
    resn = mol.res_names or ["UNL"] * mol.n_atoms
    resi = mol.res_ids or [1] * mol.n_atoms
    chains = mol.chains or ["A"] * mol.n_atoms
    het = mol.hetero or [False] * mol.n_atoms
    for i in range(mol.n_atoms):
        x, y, z = mol.positions[i]
        rec = "HETATM" if het[i] else "ATOM  "
        nm = names[i]
        nm_f = f" {nm:<3s}" if len(nm) < 4 else nm[:4]
        out.append(
            f"{rec}{i+1:5d} {nm_f} {resn[i]:<3s} {chains[i]}{resi[i]:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          "
            f"{mol.elements[i]:>2s}")
    for i, j in mol.bonds:
        out.append(f"CONECT{i+1:5d}{j+1:5d}")
    out.append("END")
    text = "\n".join(out) + "\n"
    if path:
        open(path, "w").write(text)
    return text
