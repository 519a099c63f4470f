#!/usr/bin/env python3
"""chip_smoke.py's screening phases alone, on one CUDA card.

    python3 scripts/screening_phases.py [--phases QR]

Runs chip_smoke's screening_phase (Q: screen_ligs of the committed
library's 269 SMILES against ibuprofen's auto pharmacophore from a
directory of SDF files, the CPU port on the first 32 ligands, the
conformer batch under the profiler, generate_conformers with FIRE on the
largest molecule and the most flexible of the rest) and
alignment_tools_phase (R:
flexible_align of the top hit, find_hydrogen_bonds on the quick start's
last snapshot, the GROMACS export of its system), with their gates, and
prints each phase's wall time after the card's name and power limit. R
needs Q's hits and phase N's run, so asking for R runs Q and N (N at
chip_smoke's N_QS_STEPS, the state R's H-bond gate was built for). A
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
    ap.add_argument("--phases", default="QR",
                    help="which of Q, R to run (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("screening_phases: no CUDA device")
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    if "R" in args.phases:
        t0 = time.perf_counter()
        _, sim_n, mol_n = C.quickstart_phase(C.N_QS_STEPS, torch, np)
        hb = C.hbond_inputs(sim_n, mol_n, np)
        asys_n, cfg_n = sim_n.assembled, sim_n.cfg
        del sim_n
        C.say(f"[phases] N: {time.perf_counter() - t0:.1f} s")
    if set(args.phases) & set("QR"):
        t0 = time.perf_counter()
        _, hits, library, template, _ = C.screening_phase(torch, np)
        C.say(f"[phases] Q: {time.perf_counter() - t0:.1f} s")
    if "R" in args.phases:
        t0 = time.perf_counter()
        top = C.align_hit(hits, template)
        C.alignment_tools_phase(library[top.name], template, hb, asys_n,
                                cfg_n, mol_n, torch, np)
        C.say(f"[phases] R: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
