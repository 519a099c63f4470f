"""Protein structure prediction: third-party model adapters + a built-in
secondary-structure baseline.

Copy of molchanica_tpu.structure_prediction:
the same host code, so its results equal the reference's bit for bit.

Reference parity: src/structure_prediction/mod.rs — Boltz-2 and OpenDDE
driven as child processes through the external-tools registry (never a
bare PATH assumption), returning an mmCIF structure; ESMFold2 kept as a
third backend (esm_fold2.rs). A missing model never prevents startup:
`predict_structure` raises a clean RuntimeError naming the tool, and
`available_models()` reports what would work.

The `baseline` model is always available: Chou–Fasman secondary-structure
propensities (Chou & Fasman, Biochemistry 13:222, 1974) smoothed over a
window, mapped to per-residue backbone dihedrals and built with the ideal-
geometry peptide builder. It is a physics-course baseline, not a deep
model — useful for seeding MD/minimization when no backend is installed,
and it exercises the identical dispatch/return path.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import external_tools as tools
from .molecules.common import MoleculeCommon

# Chou-Fasman helix / sheet propensities (published table)
_CF_HELIX = {
    "A": 1.42, "C": 0.70, "D": 1.01, "E": 1.51, "F": 1.13, "G": 0.57,
    "H": 1.00, "I": 1.08, "K": 1.16, "L": 1.21, "M": 1.45, "N": 0.67,
    "P": 0.57, "Q": 1.11, "R": 0.98, "S": 0.77, "T": 0.83, "V": 1.06,
    "W": 1.08, "Y": 0.69,
}
_CF_SHEET = {
    "A": 0.83, "C": 1.19, "D": 0.54, "E": 0.37, "F": 1.38, "G": 0.75,
    "H": 0.87, "I": 1.60, "K": 0.74, "L": 1.30, "M": 1.05, "N": 0.89,
    "P": 0.55, "Q": 1.10, "R": 0.93, "S": 0.75, "T": 1.19, "V": 1.70,
    "W": 1.37, "Y": 1.47,
}

# canonical backbone dihedrals per secondary-structure state
_DIHEDRALS = {"H": (-57.0, -47.0), "E": (-135.0, 135.0),
              "C": (-75.0, 145.0)}

MODELS = ("boltz2", "opendde", "esmfold", "baseline")


def assign_secondary_structure(seq: str, window: int = 5) -> str:
    """Smoothed Chou-Fasman state string over {H, E, C}."""
    seq = seq.upper()
    pa = np.array([_CF_HELIX.get(c, 1.0) for c in seq])
    pb = np.array([_CF_SHEET.get(c, 1.0) for c in seq])
    k = np.ones(window) / window
    pa_s = np.convolve(pa, k, mode="same")
    pb_s = np.convolve(pb, k, mode="same")
    ss = np.where((pa_s > 1.03) & (pa_s >= pb_s), "H",
                  np.where(pb_s > 1.05, "E", "C"))
    # helices/sheets shorter than 3 collapse to coil (CF nucleation rule)
    out = list(ss)
    i = 0
    n = len(out)
    while i < n:
        j = i
        while j < n and out[j] == out[i]:
            j += 1
        if out[i] in "HE" and j - i < 3:
            for t in range(i, j):
                out[t] = "C"
        i = j
    return "".join(out)


def _predict_baseline(seq: str) -> MoleculeCommon:
    from .molecules.peptide_builder import build_peptide

    ss = assign_secondary_structure(seq)
    phi = np.array([_DIHEDRALS[s][0] for s in ss])
    psi = np.array([_DIHEDRALS[s][1] for s in ss])
    mol = build_peptide(seq, phi=phi, psi=psi)
    mol.metadata = dict(getattr(mol, "metadata", {}) or {},
                        ss=ss, predictor="baseline")
    return mol


def _read_structure(path: str) -> MoleculeCommon:
    if path.endswith(".cif") or path.endswith(".mmcif"):
        from .io.mmcif import read_mmcif
        return read_mmcif(path)
    from .io.pdb import read_pdb
    return read_pdb(path)


def _find_output(wd: str, exts=(".cif", ".mmcif", ".pdb")) -> Optional[str]:
    hits = []
    for root, _d, files in os.walk(wd):
        for f in files:
            if f.endswith(exts):
                hits.append(os.path.join(root, f))
    return sorted(hits)[0] if hits else None


@dataclass
class BoltzOptions:
    """Reference boltz2::BoltzOptions analog."""
    ligand_smiles: Optional[str] = None
    affinity_binder: bool = False
    extra_args: List[str] = field(default_factory=list)


def predict_boltz2(seq: str, options: Optional[BoltzOptions] = None,
                   timeout: int = 3600):
    """Boltz-2 prediction; returns (MoleculeCommon, affinity dict|None).

    Builds the YAML input (protein chain A + optional ligand B), runs the
    managed `boltz` CLI, parses the top model mmCIF and — when
    affinity_binder is set — the affinity json (ref boltz2.rs:affinity)."""
    opt = options or BoltzOptions()
    tools.require("boltz2")
    wd = tempfile.mkdtemp(prefix="boltz2_")
    lines = ["version: 1", "sequences:",
             "  - protein:", "      id: A",
             f"      sequence: {seq}"]
    if opt.ligand_smiles:
        lines += ["  - ligand:", "      id: B",
                  f"      smiles: '{opt.ligand_smiles}'"]
    if opt.affinity_binder and opt.ligand_smiles:
        lines += ["properties:", "  - affinity:", "      binder: B"]
    inp = os.path.join(wd, "input.yaml")
    with open(inp, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    tools.run_tool("boltz2", ["predict", inp, "--out_dir", wd,
                              *opt.extra_args], cwd=wd, timeout=timeout)
    out = _find_output(wd)
    if out is None:
        raise RuntimeError(f"boltz2 produced no structure under {wd}")
    mol = _read_structure(out)
    affinity = None
    for root, _d, files in os.walk(wd):
        for f in files:
            if f.startswith("affinity") and f.endswith(".json"):
                with open(os.path.join(root, f)) as fh:
                    affinity = json.load(fh)
    return mol, affinity


def _predict_subprocess(name: str, seq: str, args_of, timeout: int):
    tools.require(name)
    wd = tempfile.mkdtemp(prefix=f"{name}_")
    fasta = os.path.join(wd, "input.fasta")
    with open(fasta, "w") as fh:
        fh.write(f">query\n{seq}\n")
    tools.run_tool(name, args_of(fasta, wd), cwd=wd, timeout=timeout)
    out = _find_output(wd)
    if out is None:
        raise RuntimeError(f"{name} produced no structure under {wd}")
    return _read_structure(out)


def available_models() -> List[str]:
    """Models that would run right now (baseline is always last)."""
    avail = [m for m in ("boltz2", "opendde", "esmfold")
             if tools.probe(m).available]
    return avail + ["baseline"]


def predict_structure(seq: str, model: str = "auto",
                      timeout: int = 3600) -> MoleculeCommon:
    """Shared dispatch (reference mod.rs dispatch): sequence -> structure.

    model: 'boltz2' | 'opendde' | 'esmfold' | 'baseline' | 'auto'
    (auto = first available backend, falling back to baseline)."""
    if model == "auto":
        model = available_models()[0]
    if model == "baseline":
        return _predict_baseline(seq)
    if model == "boltz2":
        return predict_boltz2(seq, timeout=timeout)[0]
    if model == "esmfold":
        return _predict_subprocess(
            "esmfold", seq,
            lambda fa, wd: ["-i", fa, "-o", wd], timeout)
    if model == "opendde":
        return _predict_subprocess(
            "opendde", seq,
            lambda fa, wd: ["predict", "--fasta", fa, "--out", wd], timeout)
    raise ValueError(f"unknown structure-prediction model: {model!r} "
                     f"(choose from {MODELS} or 'auto')")
