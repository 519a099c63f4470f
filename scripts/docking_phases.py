#!/usr/bin/env python3
"""chip_smoke.py's docking and density phases alone, on one CUDA card.

    python3 scripts/docking_phases.py [--shots N] [--phases KLM]

Runs chip_smoke's docking_phase (K: the pocket fixture's 27,360 poses
scored on the card against the CPU), shoot_phase (L: dock_md_multi with N
shots, default chip_smoke.N_SHOTS) and density_phase (M: the receptor's
density, its structure factors' round trip, samples and surface), with
their gates, and prints each phase's wall time after the card's name and
power limit. A failing gate exits non-zero, as in chip_smoke.py.
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
    ap.add_argument("--shots", type=int, default=C.N_SHOTS,
                    help="MD shots of phase L (default %(default)s)")
    ap.add_argument("--phases", default="KLM",
                    help="which of K, L, M to run (default %(default)s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("docking_phases: no CUDA device")
    C.N_SHOTS = args.shots
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    for name, fn in (("K", C.docking_phase), ("L", C.shoot_phase),
                     ("M", C.density_phase)):
        if name in args.phases:
            t0 = time.perf_counter()
            fn(torch, np)
            C.say(f"[phases] {name}: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
