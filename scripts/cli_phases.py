#!/usr/bin/env python3
"""chip_smoke.py's CLI phase alone, on one CUDA card.

    python3 scripts/cli_phases.py

Runs chip_smoke's cli_phase (Y): the CLI as a user runs it
(`python3 -m molchanica_tpu_torch` with fetch, characterize, energy,
minimize, md, predict, png and session save, on its default device, the
card), the embedded tables without pandas, FastSim's general virtual-site
path on the hydration system with jittered M weights (the K1 kernels
built from csrc/ at first use), `bg md` with `energy` while it runs, and
config 3's committed state (eq25k.npz) rendered as a 25k-site frame on
the card against the CPU. It first builds what the whole script's earlier
phases hold: config 3 and phase 11's hydration system after phase 13's
minimize. Prints the card's name and power limit, then the phase's wall
time. A failing gate exits non-zero, as in chip_smoke.py.

    python3 scripts/cli_phases.py --vsite-steps 100

also times FastSim's two virtual-site paths on config 3 at the committed
state: the rolled path on its blocked OPC waters against the gather path
on the same system with one reordered vsite row, each for 100 steps
after 100 untimed ones, in two alternating rounds.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vsite-steps", type=int, default=0, metavar="N",
                    help="after Y, time both vsite paths on config 3 for N "
                    "steps each (default: off)")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as C

    if not torch.cuda.is_available():
        raise SystemExit("cli_phases: no CUDA device")
    C.say(f"[card] {C.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    t0 = time.perf_counter()
    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    x3 = np.load(C.FIXTURE)["x"]
    asys_h, cfg_h, sim_h = C.hydration_system(torch, np)
    sim_h.minimize(cfg_h.neighbor_rebuild_every)
    x_h = sim_h.positions_unsorted()
    del sim_h
    C.say(f"[phases] set-up {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    C.cli_phase(asys, x3, 0.0, asys_h, cfg_h, x_h, torch, np)
    C.say(f"[phases] Y: {time.perf_counter() - t0:.1f} s")
    if args.vsite_steps:
        d = np.load(C.FIXTURE)
        C.vsite_paths(asys.topology, C.config3_cfg(), d["x"],
                      asys.box_extent, args.vsite_steps, torch, np,
                      "config 3", v=d["v"])


if __name__ == "__main__":
    main()
