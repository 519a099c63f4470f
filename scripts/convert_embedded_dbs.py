#!/usr/bin/env python3
"""Convert the embedded molecule databases from parquet to numpy's .npz.

    python3 scripts/convert_embedded_dbs.py

Reads molchanica_tpu/data/{metabolites_hmdb_core,compounds_chebi_core}.parquet
with pandas and writes molchanica_tpu_torch/data/<name>.npz: one array
per column, in the parquet's column order and dtypes (float64, int64;
fixed-width unicode for the string columns), loadable with
np.load(path, allow_pickle=False). The port reads these files with numpy
alone; pandas is needed only here.
"""
import os

import numpy as np
import pandas as pd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("metabolites_hmdb_core", "compounds_chebi_core")


def convert(name):
    df = pd.read_parquet(os.path.join(ROOT, "molchanica_tpu", "data",
                                      f"{name}.parquet"))
    cols = {}
    for c in df.columns:
        if df[c].dtype.kind in "fi":
            cols[c] = df[c].to_numpy()
        else:
            cols[c] = np.asarray(df[c].tolist(), dtype=str)
    out = os.path.join(ROOT, "molchanica_tpu_torch", "data", f"{name}.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez(out, **cols)
    print(f"{out}: {len(df)} rows, "
          + ", ".join(f"{c} {a.dtype}" for c, a in cols.items()))


if __name__ == "__main__":
    for n in NAMES:
        convert(n)
