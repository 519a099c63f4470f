#!/usr/bin/env python3
"""chip_smoke.py's MD user-layer phases alone, on one CUDA card.

    python3 scripts/user_layer_phases.py [--phases NOP] [--witness N]

Builds the kernels, then runs chip_smoke's quickstart_phase (N: the
README's quick start on the committed ligand, card vs CPU force of it
and of the README's 10 A build, a timed run_dynamics_blocking),
ligand_k2_phase (O: the same ligand on K2 in a 36 A cube, K2 against its
plain version, launches against force evaluations) and
checkpoint_trajectory_phase (P: a checkpoint of O's state restored bit
for bit, two continuations, N's snapshots through DCD, TRR, XTC and GRO,
the viewer), with their gates, and prints each phase's wall time after the
card's name and power limit. P needs N's and O's results, so asking for P
runs them. A failing gate exits non-zero, as in chip_smoke.py.

--witness N first runs the README's quick start as written (pad 10 A:
1,973 sites on allpairs_cutoff) for N steps, printing the temperature and
potential energy every N/10 steps; it gates nothing.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def witness(n_steps, C):
    """The README's quick start at its own pad on the card: T and E_pot
    along n_steps steps of 2 fs."""
    sim, _ = C.quickstart_build(C.quickstart_cfg(C.QS_README_PAD), "cuda")
    r = sim.relax_log
    C.say(f"[witness] pad {C.QS_README_PAD:g} A: "
          f"{sim.assembled.topology.n_atoms_real} sites, method "
          f"{sim.method}; FIRE {r['iters']} iterations ({r['path']}, kept "
          f"{r['kept']}), E {r['e_first']:.3f} -> {r['e_last']:.3f}; "
          f"T {sim.temperature():.1f} K")
    every = max(n_steps // 10, 1)
    for done in range(every, n_steps + 1, every):
        sim.step(0.002, every)
        C.say(f"[witness] step {done}: T {sim.temperature():.1f} K, E_pot "
              f"{float(sim.state.pe_last):.3f} kcal/mol")


def main():
    import numpy as np
    import torch

    import chip_smoke as C

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="NOP",
                    help="which of N, O, P to run (default %(default)s)")
    ap.add_argument("--witness", type=int, default=0, metavar="N",
                    help="first run the README's pad-10 quick start for N "
                    "steps (off by default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("user_layer_phases: no CUDA device")
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    from molchanica_tpu_torch import cuda_build
    cuda_build.build()
    if args.witness:
        t0 = time.perf_counter()
        witness(args.witness, C)
        C.say(f"[phases] witness: {time.perf_counter() - t0:.1f} s")
    want = set(args.phases) | (set("NO") if "P" in args.phases else set())
    if "N" in want:
        t0 = time.perf_counter()
        _, sim_n, mol = C.quickstart_phase(C.N_QS_STEPS, torch, np)
        C.say(f"[phases] N: {time.perf_counter() - t0:.1f} s")
    if "O" in want:
        t0 = time.perf_counter()
        _, md_o = C.ligand_k2_phase(C.N_O_WARM, C.N_O_STEPS, torch, np)
        C.say(f"[phases] O: {time.perf_counter() - t0:.1f} s")
    if "P" in want:
        t0 = time.perf_counter()
        C.checkpoint_trajectory_phase(md_o, sim_n, mol, torch, np)
        C.say(f"[phases] P: {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
