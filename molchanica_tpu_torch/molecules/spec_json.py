"""MolSpecs kept as JSON data files (systems/data/*.json).

The port has no SMILES parser, embedder or force-field typing yet, so a
parameterized solute that a workload needs is committed as its MolSpec:
every field, numbers as JSON floats (exact round trip), index lists as
lists. `spec_to_dict` writes one from any object with MolSpec's fields.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .spec import MolSpec

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "systems", "data")
# methanol ("CO"), GAFF2 types, Gasteiger charges, force-directed embedding
METHANOL_GAFF2 = os.path.join(DATA_DIR, "methanol_gaff2.json")

_ARRAYS = ("masses", "charges", "lj_sigma", "lj_eps")


def spec_to_dict(spec) -> dict:
    """JSON-ready dict of a MolSpec (or an object with its fields)."""
    def floats(a):
        return [float(v) for v in np.asarray(a, np.float64).ravel()]

    def rows(terms, n_idx):
        return [[int(v) for v in t[:n_idx]] + [float(v) for v in t[n_idx:]]
                for t in terms]

    return dict(
        **{k: floats(getattr(spec, k)) for k in _ARRAYS},
        positions=np.asarray(spec.positions, np.float64).tolist(),
        bonds=rows(spec.bonds, 2),
        angles=rows(spec.angles, 3),
        dihedrals=rows(spec.dihedrals, 4),
        pairs14=None if spec.pairs14 is None else rows(spec.pairs14, 2),
        exclusions=(None if spec.exclusions is None else
                    [[int(i), int(j)] for i, j in spec.exclusions]),
        hclusters=[[int(h), [int(v) for v in hs], [float(v) for v in r0]]
                   for h, hs, r0 in spec.hclusters],
        ff_mol_type=spec.ff_mol_type,
        static_=bool(spec.static_),
        bonded_only=bool(spec.bonded_only),
    )


def spec_from_dict(d: dict) -> MolSpec:
    def terms(key, n_idx):
        return [tuple(int(v) for v in t[:n_idx]) + tuple(float(v)
                                                         for v in t[n_idx:])
                for t in d[key]]

    return MolSpec(
        **{k: np.asarray(d[k], np.float64) for k in _ARRAYS},
        positions=np.asarray(d["positions"], np.float64),
        bonds=terms("bonds", 2), angles=terms("angles", 3),
        dihedrals=terms("dihedrals", 4),
        pairs14=None if d["pairs14"] is None else terms("pairs14", 2),
        exclusions=(None if d["exclusions"] is None else
                    [(int(i), int(j)) for i, j in d["exclusions"]]),
        hclusters=[(int(h), [int(v) for v in hs], [float(v) for v in r0])
                   for h, hs, r0 in d["hclusters"]],
        ff_mol_type=d["ff_mol_type"], static_=d["static_"],
        bonded_only=d["bonded_only"])


def load_spec(path: str) -> MolSpec:
    with open(path) as fh:
        return spec_from_dict(json.load(fh))


def methanol() -> MolSpec:
    """The committed methanol MolSpec (see tests/test_torch_alchemical.py
    for how the file is made)."""
    return load_spec(METHANOL_GAFF2)
