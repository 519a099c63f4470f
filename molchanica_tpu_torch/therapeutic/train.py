"""Training orchestration for therapeutic targets.

Reference parity: train.rs:1914 (per-target training entry point: dataset ->
features -> Adam+cosine -> metrics -> embedded weight export).

Port of molchanica_tpu.therapeutic.train, training on the card (unless
device="cpu"). One departure: the weights go to `weights_dir`, by default
the port's own WEIGHTS_DIR, never into the reference package (whose
train_target writes its package's committed weights).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..models.adme import (AdmeModelConfig, predict_adme, save_weights,
                           train_adme)
from ..models.eval import evaluate
from .data import builtin_smiles, load_csv_dataset, split_dataset
from .targets import (EXPERIMENTAL_DATA, REFERENCE_DIR, TARGETS,
                      compute_labels)

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights")


def _mols_from_smiles(smiles: List[str]):
    from ..molecules.smiles import from_smiles

    mols, keep = [], []
    for i, smi in enumerate(smiles):
        try:
            mols.append(from_smiles(smi))
            keep.append(i)
        except Exception:
            continue
    return mols, keep


def train_target(name: str, csv: Optional[str] = None,
                 n_epochs: int = 50, seed: int = 0,
                 save: bool = True, n_mols: int = 640,
                 weights_dir: Optional[str] = None, device=None) -> Dict:
    """Train one target end-to-end; returns {target, metrics, n_train,
    n_test, history (every epoch), history_tail, test_pred and, when
    saved, weights_path}.

    With csv=None the built-in generated dataset + computed labels are
    used (see therapeutic/data.py), or the committed measured CSV of a
    target in EXPERIMENTAL_DATA; point csv at a TDC download for measured
    labels. The file is weights_dir/<name>.pt (weights_dir defaults to
    WEIGHTS_DIR).
    """
    spec = TARGETS[name]
    if csv is None and name in EXPERIMENTAL_DATA:
        csv = os.path.join(REFERENCE_DIR, EXPERIMENTAL_DATA[name])
    if csv is not None:
        smiles, y = load_csv_dataset(csv)
        mols, keep = _mols_from_smiles(smiles)
        y = y[keep]
    else:
        smiles = builtin_smiles(n_mols)
        mols, _ = _mols_from_smiles(smiles)
        y = compute_labels(spec, mols)

    tr, va, te = split_dataset(len(mols), seed=seed)
    cfg = AdmeModelConfig(classification=spec.classification)
    state, scaler, history = train_adme(
        [mols[i] for i in tr] + [mols[i] for i in va],
        np.concatenate([y[tr], y[va]]),
        cfg=cfg, n_epochs=n_epochs, seed=seed,
        val_fraction=len(va) / max(len(tr) + len(va), 1), device=device)

    pred_te = np.asarray(predict_adme(state, [mols[i] for i in te], scaler,
                                      cfg, device=device))
    metrics = evaluate(y[te], pred_te, classification=spec.classification)

    out = {"target": name, "metrics": metrics, "n_train": len(tr),
           "n_test": len(te), "history": history,
           "history_tail": history[-3:], "test_pred": pred_te}
    if save:
        weights_dir = weights_dir or WEIGHTS_DIR
        os.makedirs(weights_dir, exist_ok=True)
        path = os.path.join(weights_dir, f"{name}.pt")
        save_weights(path, state, scaler, cfg, metrics, name)
        out["weights_path"] = path
    return out


def train_all(names=None, **kw) -> Dict[str, Dict]:
    """Train every registered target (reference trains all 24 TDC tasks)."""
    results = {}
    for name in (names or TARGETS):
        results[name] = train_target(name, **kw)
    return results
