"""Batched ligand screening over files/directories (port of
molchanica_tpu.screening.screen).

Reference: src/screening/mod.rs — batched SDF/Mol2 directory screening with
an atom-count-bounded cache (1M atoms, :27); per-ligand conformer generation
and pharmacophore scoring (screen_ligs, pharmacophore.rs:781).

Each ligand's conformer energies run on the device. A ligand whose host
preparation fails (typing, assembly, torsion sampling) is scored on its
own positions, as in the reference; unlike the reference, a failure of the
device work is not caught, so it stops the screen.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..device import resolve_device
from ..molecules.common import MoleculeCommon
from ..molecules.conformers import prepare_conformers, rank_conformers
from .pharmacophore import Pharmacophore

MAX_CACHED_ATOMS = 1_000_000   # reference cache bound (screening/mod.rs:27)


@dataclass
class ScreenHit:
    name: str
    score: float
    conformer: int
    source: str
    # the host preparation's error where the ligand was scored on its own
    # positions (no conformers), else None
    fallback: Optional[str] = None


def _iter_ligands(source) -> List[MoleculeCommon]:
    from ..io import open_file

    if isinstance(source, MoleculeCommon):
        return [source]
    p = Path(source)
    if p.is_dir():
        out = []
        total_atoms = 0
        for f in sorted(p.iterdir()):
            if f.suffix.lower() in (".sdf", ".mol", ".mol2"):
                mols = open_file(f)
                mols = mols if isinstance(mols, list) else [mols]
                for m in mols:
                    m.name = m.name or f.stem
                    total_atoms += m.n_atoms
                    if total_atoms > MAX_CACHED_ATOMS:
                        return out
                    out.append(m)
        return out
    mols = open_file(p)
    return mols if isinstance(mols, list) else [mols]


def _best_score(pharmacophore, mol, coord_sets, align, ph_centroid):
    """(best score, its conformer index) over the coordinate sets, each
    moved to the pharmacophore's centroid when aligning, with three axis
    flips tried below a perfect score."""
    best = (-1.0, 0)
    for ci, coords in enumerate(coord_sets):
        c = np.asarray(coords, float)
        if align:
            c = c - c.mean(axis=0) + ph_centroid
        m = copy.copy(mol)
        m.positions = c
        s = pharmacophore.score(m)
        # cheap rotation search: score a few axis flips too
        if align and s < 0.999:
            for ax in range(3):
                R = np.eye(3)
                R[ax, ax] = 1.0
                R[(ax + 1) % 3, (ax + 1) % 3] = -1.0
                R[(ax + 2) % 3, (ax + 2) % 3] = -1.0
                m2 = copy.copy(mol)
                m2.positions = (c - ph_centroid) @ R + ph_centroid
                s = max(s, pharmacophore.score(m2))
        if s > best[0]:
            best = (s, ci)
    return best


def screen_ligs(
    pharmacophore: Pharmacophore,
    source: Union[str, Path, Sequence[MoleculeCommon]],
    n_conformers: int = 8,
    min_score: float = 0.0,
    align: bool = True,
    seed: int = 0,
    device=None,
) -> List[ScreenHit]:
    """Score every ligand (over conformers, optionally rigid-aligned to the
    pharmacophore centroid frame); returns hits sorted by score. The
    conformer energies run on `device` (None: the CUDA card)."""
    dev = resolve_device(device)
    if isinstance(source, (str, Path)):
        ligands = _iter_ligands(source)
    else:
        ligands = list(source)

    ph_centroid = (np.mean([f.position for f in pharmacophore.features],
                           axis=0) if pharmacophore.features else np.zeros(3))
    hits: List[ScreenHit] = []
    for mol in ligands:
        try:
            prep = prepare_conformers(mol, n_conformers=n_conformers,
                                      seed=seed)
            fallback = None
        except Exception as e:
            prep, fallback = None, repr(e)
        if prep is None:
            coord_sets = np.asarray(mol.positions)[None]
        else:
            coord_sets = rank_conformers(prep, dev).coords
        score, conformer = _best_score(pharmacophore, mol, coord_sets, align,
                                       ph_centroid)
        if score >= min_score:
            hits.append(ScreenHit(name=mol.name or "?", score=score,
                                  conformer=conformer, source=str(source),
                                  fallback=fallback))
    hits.sort(key=lambda h: -h.score)
    return hits
