#!/usr/bin/env python3
"""chip_smoke.py's therapeutic-model phases alone, on one CUDA card.

    python3 scripts/therapeutic_phases.py [--phases STU]

Runs chip_smoke's adme_phase (S: the 27 committed ADME weights files
through the JAX-free loader, predict_mols on the card over the library,
raw outputs against the CPU port, compute_therapeutic_properties card vs
CPU, the measured orderings), train_phase (T: train_target of
logp_experimental on the card and on the CPU port, its saved file
reloaded, the reference package left untouched) and mpnn_phase (U:
ProteinMPNN at full width on a 250-residue polyalanine backbone, forward,
conditional scoring, MPNN_SAMPLES designs, ddg_scan), with their gates,
and prints each phase's wall time after the card's name and power limit.
S and T read the library that chip_smoke's phase Q parses (the committed
CSVs' unique SMILES through from_smiles); here it is parsed first. A
failing gate exits non-zero, as in chip_smoke.py.
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
    ap.add_argument("--phases", default="STU",
                    help="which of S, T, U to run (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("therapeutic_phases: no CUDA device")
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    if set(args.phases) & set("ST"):
        from molchanica_tpu_torch.molecules.smiles import from_smiles

        t0 = time.perf_counter()
        parsed = {s: from_smiles(s) for s in C.screening_library()}
        C.say(f"[phases] library: {len(parsed)} SMILES through from_smiles "
              f"in {time.perf_counter() - t0:.1f} s")
    for tag, run in (("S", lambda: C.adme_phase(parsed, torch, np)),
                     ("T", lambda: C.train_phase(parsed, torch, np)),
                     ("U", lambda: C.mpnn_phase(torch, np))):
        if tag in args.phases:
            t0 = time.perf_counter()
            run()
            C.say(f"[phases] {tag}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
