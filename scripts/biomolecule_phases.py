#!/usr/bin/env python3
"""chip_smoke.py's biomolecule-builder phases alone, on one CUDA card.

    python3 scripts/biomolecule_phases.py [--phases VWX]

Runs chip_smoke's protein_phase (V: HP35 from its sequence through the
baseline predictor, an mmCIF round trip and prepare_peptide, solvated in
OPC through build_dynamics and run for 400 steps; then BASELINE config 2,
the 12-mer in vacuum), duplex_phase (W: the GATTACA duplex of config 5,
solvated the same way) and membrane_editor_phase (X: make_membrane() dry
in its box, then MolEditor's live MD), with their gates, and prints each
phase's wall time after the card's name and power limit. A failing gate
exits non-zero, as in chip_smoke.py.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch

    import chip_smoke as C

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="VWX",
                    help="which of V, W, X to run (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("biomolecule_phases: no CUDA device")
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    for tag, run in (("V", C.protein_phase), ("W", C.duplex_phase),
                     ("X", C.membrane_editor_phase)):
        if tag in args.phases:
            t0 = time.perf_counter()
            run(torch, np)
            C.say(f"[phases] {tag}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
