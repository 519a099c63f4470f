"""Evaluation metrics for property models (reference src/therapeutic/eval.rs:
MSE/RMSE/MAE/Pearson/Spearman/AUROC) + scaffold splitting.

Copy of molchanica_tpu.models.eval:
the same host code, so its results equal the reference's bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def mse(y, p):
    y, p = np.asarray(y, float), np.asarray(p, float)
    return float(np.mean((y - p) ** 2))


def rmse(y, p):
    return float(np.sqrt(mse(y, p)))


def mae(y, p):
    y, p = np.asarray(y, float), np.asarray(p, float)
    return float(np.mean(np.abs(y - p)))


def pearson(y, p):
    y, p = np.asarray(y, float), np.asarray(p, float)
    ys, ps = y - y.mean(), p - p.mean()
    d = np.sqrt((ys ** 2).sum() * (ps ** 2).sum())
    return float((ys * ps).sum() / d) if d > 0 else 0.0


def spearman(y, p):
    def rank(a):
        order = np.argsort(a)
        r = np.empty_like(order, float)
        r[order] = np.arange(len(a))
        return r
    return pearson(rank(np.asarray(y)), rank(np.asarray(p)))


def auroc(y, p):
    """Binary AUROC via the rank statistic."""
    y = np.asarray(y) > 0.5
    p = np.asarray(p, float)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(p)
    ranks = np.empty(len(p), float)
    ranks[order] = np.arange(1, len(p) + 1)
    # tie-average
    for v in np.unique(p):
        m = p == v
        if m.sum() > 1:
            ranks[m] = ranks[m].mean()
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2)
                 / (n_pos * n_neg))


def evaluate(y, p, classification=False) -> Dict[str, float]:
    out = dict(mse=mse(y, p), rmse=rmse(y, p), mae=mae(y, p),
               pearson=pearson(y, p), spearman=spearman(y, p))
    if classification:
        out["auroc"] = auroc(y, p)
    return out


def scaffold_split(mols: Sequence, test_fraction: float = 0.2,
                   seed: int = 0):
    """Group molecules by ring-scaffold key; whole groups go to test
    (reference scaffold-split eval via train_test_split_indices)."""
    from ..molecules.characterization import characterize

    keys = []
    for m in mols:
        c = characterize(m)
        ring_sizes = tuple(sorted(len(r) for r in c.rings))
        keys.append((ring_sizes, c.n_aromatic_rings,
                     round(c.mol_weight, -1)))
    groups: Dict[tuple, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    rng = np.random.default_rng(seed)
    order = list(groups.values())
    rng.shuffle(order)
    n_test = int(len(mols) * test_fraction)
    test: List[int] = []
    for g in order:
        if len(test) >= n_test:
            break
        test.extend(g)
    test_set = set(test)
    train = [i for i in range(len(mols)) if i not in test_set]
    return train, sorted(test_set)
