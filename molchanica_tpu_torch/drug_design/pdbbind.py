"""Reading a locally downloaded PDBbind release.

Copy of molchanica_tpu.drug_design.pdbbind:
the same host code, so its results equal the reference's bit for bit.

Counterpart of src/drug_design/pdbbind.rs:1-120: a PDBbind
release is a directory tree — index/INDEX_*_data.* holds one affinity line
per complex, and each complex directory holds the protein, pocket, and
ligand as separate files:

    <root>/
        index/INDEX_refined_data.2020
        refined-set/1a30/1a30_protein.pdb
                        /1a30_pocket.pdb
                        /1a30_ligand.sdf
                        /1a30_ligand.mol2

This reads a copy the user already obtained under their own PDBbind+
agreement (nothing downloads it). Root discovery: the
MOLCHANICA_PDBBIND_ROOT env var (pdbbind.rs:121 reads the same-named
reference variable).

Index lines look like (pdbbind.rs:479):
    2r58  2.00  2007   2.00  Kd=10mM       // 2r58.pdf (MLY)
"""
from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

SUBSET_DIRS = {
    "refined": ["refined-set", "refined_set", "refined"],
    "general": ["general-set", "general_set", "general",
                "general-set-except-refined"],
    "core": ["core-set", "core_set", "core", "coreset"],
}
SUBSET_DIRS["any"] = (SUBSET_DIRS["refined"] + SUBSET_DIRS["general"]
                      + SUBSET_DIRS["core"])

_UNITS = {"mm": 1e-3, "um": 1e-6, "nm": 1e-9, "pm": 1e-12, "fm": 1e-15,
          "m": 1.0}


@dataclass
class Affinity:
    """One measured binding affinity (pdbbind.rs Affinity, :57-70)."""
    kind: str                  # "Kd" | "Ki" | "IC50"
    relation: str              # "=", "<", ">", "~", "<=", ">="
    p_value: float             # -log10(molar), the index's 4th column
    molar: Optional[float] = None
    resolution: Optional[float] = None
    year: Optional[int] = None
    raw: str = ""

    @property
    def is_exact(self) -> bool:
        return self.relation in ("=", "~")

    def is_regression_quality(self) -> bool:
        """Exact Kd/Ki measurements are what affinity regressors train on
        (IC50 is assay-dependent; inequalities are censored labels)."""
        return self.is_exact and self.kind in ("Kd", "Ki")


@dataclass
class Entry:
    """One complex directory (pdbbind.rs Entry, :85-118)."""
    pdb_id: str
    directory: Path
    subset_directory: str
    protein: Optional[Path] = None
    pocket: Optional[Path] = None
    ligand_sdf: Optional[Path] = None
    ligand_mol2: Optional[Path] = None
    affinity: Optional[Affinity] = None

    @property
    def ligand(self) -> Optional[Path]:
        return self.ligand_sdf or self.ligand_mol2

    @property
    def structure_for_pocket_work(self) -> Optional[Path]:
        """Pocket file when present (already cut to the site), else the
        full protein (pdbbind.rs:112)."""
        return self.pocket or self.protein


def find_root(root=None) -> Optional[Path]:
    root = root or os.environ.get("MOLCHANICA_PDBBIND_ROOT")
    if root is None:
        return None
    p = Path(root)
    return p if p.is_dir() else None


def parse_measurement(raw: str):
    """'Kd=10mM' / 'Ki~5.2uM' / 'IC50>100nM' -> (kind, relation, molar)."""
    m = re.match(r"\s*(Kd|Ki|IC50)\s*([<>~=]=?)\s*([0-9.eE+-]+)\s*([a-zA-Z]+)",
                 raw)
    if not m:
        return None
    kind, rel, num, unit = m.groups()
    scale = _UNITS.get(unit.lower())
    try:
        molar = float(num) * scale if scale else None
    except ValueError:
        molar = None
    return kind, rel, molar


def parse_index_line(line: str):
    """One index data row -> (pdb_id, Affinity) or None (pdbbind.rs:384)."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    fields = line.split()
    if len(fields) < 5:
        return None
    pdb_id = fields[0].lower()
    if len(pdb_id) != 4:
        return None
    try:
        resolution = float(fields[1])
    except ValueError:
        resolution = None            # "NMR" etc.
    try:
        year = int(fields[2])
    except ValueError:
        year = None
    try:
        p_value = float(fields[3])
    except ValueError:
        return None
    raw = fields[4]
    meas = parse_measurement(raw)
    if meas is None:
        return None
    kind, rel, molar = meas
    if molar is None and math.isfinite(p_value):
        molar = 10.0 ** (-p_value)
    return pdb_id, Affinity(kind=kind, relation=rel, p_value=p_value,
                            molar=molar, resolution=resolution, year=year,
                            raw=raw)


def load_index(root) -> Dict[str, Affinity]:
    """Parse every index/INDEX_*_data.* file into one lookup
    (pdbbind.rs:332)."""
    root = Path(root)
    out: Dict[str, Affinity] = {}
    idx_dir = root / "index"
    files: List[Path] = []
    if idx_dir.is_dir():
        files = [p for p in idx_dir.iterdir()
                 if p.name.startswith("INDEX") and "_data" in p.name]
    for f in sorted(files):
        for line in f.read_text(errors="replace").splitlines():
            parsed = parse_index_line(line)
            if parsed:
                out.setdefault(parsed[0], parsed[1])
    return out


def _entry_from_dir(d: Path, subset_dir: str,
                    affinities: Dict[str, Affinity]) -> Entry:
    code = d.name.lower()

    def opt(suffix):
        p = d / f"{d.name}_{suffix}"
        return p if p.is_file() else None

    return Entry(pdb_id=code, directory=d, subset_directory=subset_dir,
                 protein=opt("protein.pdb"), pocket=opt("pocket.pdb"),
                 ligand_sdf=opt("ligand.sdf"), ligand_mol2=opt("ligand.mol2"),
                 affinity=affinities.get(code))


def load_entries(root=None, subset: str = "refined") -> List[Entry]:
    """All complex entries in a release subset, index-joined."""
    root = find_root(root)
    if root is None:
        return []
    affinities = load_index(root)
    out = []
    seen = set()
    for dname in SUBSET_DIRS[subset]:
        sd = root / dname
        if not sd.is_dir():
            continue
        for d in sorted(sd.iterdir()):
            if d.is_dir() and len(d.name) == 4 and d.name not in seen:
                seen.add(d.name)
                out.append(_entry_from_dir(d, dname, affinities))
    return out


def load_entry(pdb_id: str, root=None, subset: str = "any") -> Optional[Entry]:
    root = find_root(root)
    if root is None:
        return None
    pdb_id = pdb_id.lower()
    for dname in SUBSET_DIRS[subset]:
        d = root / dname / pdb_id
        if d.is_dir():
            return _entry_from_dir(d, dname, load_index(root))
    return None
