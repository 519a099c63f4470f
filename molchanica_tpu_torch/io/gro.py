"""GROMACS .gro reader/writer (the reference's MD auto-save format,
src/md/mod.rs:145 `./md_out/traj_N.gro`; save_mol_set_as_gro at
src/file_io/mod.rs:1139). Units: .gro is nm; we convert to/from A.

Copy of molchanica_tpu.io.gro:
the same host code, so its results equal the reference's bit for bit,
plus read_gro_trajectory, which reads every frame of a multi-frame file
(the JAX package reads a .gro's first frame only).
"""
from __future__ import annotations

import numpy as np

from ..molecules.common import MoleculeCommon

NM = 10.0   # A per nm


def read_gro(path):
    """Returns (MoleculeCommon, box_extent_A). Multi-frame: first frame."""
    lines = open(path).read().splitlines()
    name = lines[0]
    n = int(lines[1])
    elements, names, resn, resi, pos, vel = [], [], [], [], [], []
    for l in lines[2:2 + n]:
        resi.append(int(l[0:5]))
        resn.append(l[5:10].strip())
        nm = l[10:15].strip()
        names.append(nm)
        e = "".join(c for c in nm if c.isalpha())
        if len(e) >= 2 and e[:2].capitalize() in ("Cl", "Br", "Na", "Mg",
                                                  "Ca", "Zn", "Fe"):
            e = e[:2].capitalize()
        else:
            e = (e[:1] or "C").upper()
        elements.append(e)
        pos.append([float(l[20:28]) * NM, float(l[28:36]) * NM,
                    float(l[36:44]) * NM])
        if len(l) >= 68:
            try:
                vel.append([float(l[44:52]) * NM, float(l[52:60]) * NM,
                            float(l[60:68]) * NM])
            except ValueError:
                pass
    box_line = lines[2 + n].split()
    box = np.array([float(v) for v in box_line[:3]]) * NM
    mol = MoleculeCommon(elements=elements, positions=np.asarray(pos),
                         atom_names=names, res_names=resn, res_ids=resi,
                         name=name)
    return mol, box


def write_gro(path, elements_or_mol, positions=None, box_extent=None,
              atom_names=None, res_names=None, res_ids=None,
              velocities=None, title="written by molchanica-tpu") -> str:
    """Write a .gro frame. Accepts a MoleculeCommon or raw arrays."""
    if isinstance(elements_or_mol, MoleculeCommon):
        mol = elements_or_mol
        elements = mol.elements
        positions = mol.positions if positions is None else positions
        atom_names = atom_names or mol.atom_names
        res_names = res_names or mol.res_names
        res_ids = res_ids or mol.res_ids
    else:
        elements = elements_or_mol
    n = len(elements)
    atom_names = atom_names or [f"{e}{i+1}" for i, e in enumerate(elements)]
    res_names = res_names or ["MOL"] * n
    res_ids = res_ids or [1] * n
    out = [title, f"{n:5d}"]
    for i in range(n):
        x, y, z = np.asarray(positions[i]) / NM
        line = (f"{res_ids[i] % 100000:5d}{res_names[i][:5]:<5s}"
                f"{atom_names[i][:5]:>5s}{(i + 1) % 100000:5d}"
                f"{x:8.3f}{y:8.3f}{z:8.3f}")
        if velocities is not None:
            vx, vy, vz = np.asarray(velocities[i]) / NM
            line += f"{vx:8.4f}{vy:8.4f}{vz:8.4f}"
        out.append(line)
    if box_extent is None:
        box_extent = np.zeros(3)
    bx, by, bz = np.asarray(box_extent) / NM
    out.append(f"{bx:10.5f}{by:10.5f}{bz:10.5f}")
    text = "\n".join(out) + "\n"
    if path:
        open(path, "w").write(text)
    return text


def write_gro_trajectory(path, elements, frames, box_extent, **kw):
    """Concatenated multi-frame .gro (the reference's traj_N.gro output)."""
    text = "".join(
        write_gro(None, elements, positions=f, box_extent=box_extent,
                  title=f"frame {i}", **kw)
        for i, f in enumerate(frames))
    open(path, "w").write(text)
    return text


def read_gro_trajectory(path):
    """Every frame of a multi-frame .gro (write_gro_trajectory's output):
    (frames [F, n, 3] A, box extents [F, 3] A)."""
    lines = open(path).read().splitlines()
    frames, boxes = [], []
    i = 0
    while i + 1 < len(lines):
        n = int(lines[i + 1])
        frames.append([[float(l[20:28]) * NM, float(l[28:36]) * NM,
                        float(l[36:44]) * NM]
                       for l in lines[i + 2:i + 2 + n]])
        boxes.append([float(v) for v in lines[i + 2 + n].split()[:3]])
        i += n + 3
    return np.asarray(frames), np.asarray(boxes) * NM
