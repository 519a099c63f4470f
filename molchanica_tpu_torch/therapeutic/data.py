"""Embedded molecule set + dataset assembly for therapeutic-target training.

The reference trains from TDC CSV datasets downloaded at build time
(src/therapeutic/train.rs data loaders). Without a download, the built-in
dataset is generated combinatorially from drug-like scaffolds x
substituents (~700 unique valid molecules through our own SMILES parser),
and labels come from the target registry's label functions (computed
physicochemical properties — real, learnable structure-property maps).
Real TDC CSVs drop into `load_csv_dataset` unchanged.

Copy of molchanica_tpu.therapeutic.data: the same host code and the same
numpy seeds, so its molecule sets and splits equal the reference's.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

SCAFFOLDS = [
    "c1ccccc1{}", "c1ccc(cc1){}", "c1ccncc1{}", "c1ccc2ccccc2c1{}",
    "C1CCCCC1{}", "C1CCNCC1{}", "c1ccc2[nH]ccc2c1{}", "c1ccsc1{}",
    "c1ccoc1{}", "C1CCOCC1{}", "c1cnc2ccccc2n1{}", "O=C1CCCCN1{}",
]
SUBSTITUENTS = [
    "", "C", "CC", "CCC", "C(C)C", "O", "OC", "N", "NC", "N(C)C",
    "C(=O)O", "C(=O)OC", "C(=O)N", "C#N", "Cl", "F", "Br", "CO",
    "CCO", "CN", "C(=O)C", "OC(=O)C", "S", "SC", "CCN", "C=C",
]
LINKERS = ["", "C", "CC", "OC", "NC", "C(=O)"]


def builtin_smiles(limit: int = 720) -> List[str]:
    """Deterministic combinatorial drug-like set, validated by our parser."""
    from ..molecules.smiles import from_smiles

    out, seen = [], set()
    rng = np.random.default_rng(20260817)
    combos = [(s, l, u) for s in SCAFFOLDS for l in LINKERS
              for u in SUBSTITUENTS]
    rng.shuffle(combos)
    for scaf, link, sub in combos:
        smi = scaf.format(link + sub)
        if smi in seen:
            continue
        seen.add(smi)
        try:
            mol = from_smiles(smi)
            if mol.n_atoms < 6:
                continue
        except Exception:
            continue
        out.append(smi)
        if len(out) >= limit:
            break
    return out


def load_csv_dataset(path, smiles_col=None, label_col=None
                     ) -> Tuple[List[str], np.ndarray]:
    """CSV loader for TDC downloads ('Drug','Y') and embedded datasets
    ('smiles','y') — columns auto-detected unless given."""
    import csv

    smiles, y = [], []
    with open(path) as f:
        reader = csv.DictReader(f)
        fields = reader.fieldnames or []
        sc = smiles_col or ("Drug" if "Drug" in fields else "smiles")
        lc = label_col or ("Y" if "Y" in fields else "y")
        for row in reader:
            smiles.append(row[sc])
            y.append(float(row[lc]))
    return smiles, np.asarray(y)


def split_dataset(n: int, seed: int = 0, frac_val: float = 0.15,
                  frac_test: float = 0.15):
    """Deterministic train/val/test index split (TDC-style random split)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_test = int(n * frac_test)
    n_val = int(n * frac_val)
    return (idx[n_test + n_val:], idx[n_test:n_test + n_val], idx[:n_test])
