#!/usr/bin/env python3
"""FIRE's energy, iteration by iteration, on config 3, on one CUDA card.

    python3 scripts/fire_trace.py [--iters N] [--every K] [--no-k2]

Runs md/minimize.py::fire_minimize (the reference's FIRE, one host loop)
from the committed eq25k.npz state through MdSim's force function, with
MdConfig's defaults at the 9 A cutoff: on the cluster backend in one run
of N iterations and as two runs of N/2 (the reference engine's blocks,
each restarting FIRE's velocity, dt and alpha), then on the cell-grid
kernel's path (use_pallas=True) unless --no-k2. Prints the energy every K
iterations, the energy at the end, the lowest evaluated energy, and the
largest and mean displacement of the sites from the start.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trace(tag, sim, blocks, every, torch):
    from molchanica_tpu_torch.md.minimize import fire_minimize

    s = sim.state
    x = s.positions
    energies, lowest = [], []
    t0 = time.perf_counter()
    with torch.no_grad():
        for n in blocks:
            best = {}
            x, _ = fire_minimize(sim.force_fn, x, s.box, s.couple,
                                 sim.top.dof_mask, n_steps=n,
                                 constrain_positions=sim._cp,
                                 energies=energies, best=best)
            lowest.append(float(best["e"]))
        e_end = float(sim.force_fn(x, s.box, s.couple)[1][0])
    torch.cuda.synchronize()
    es = [float(e) for e in energies]
    move = (x - s.positions).norm(dim=1)
    print(f"[{tag}] {time.perf_counter() - t0:.1f} s; E every {every}: "
          + " ".join(f"{i}:{es[i]:.0f}" for i in range(0, len(es), every))
          + f"; end {e_end:.1f}; lowest {min(lowest):.1f} at iteration "
          f"{es.index(min(es))}; move max {float(move.max()):.3f} A, mean "
          f"{float(move.mean()):.3f} A", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--no-k2", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("fire_trace: no CUDA device")
    sys.path.insert(0, ROOT)
    from molchanica_tpu_torch.md.config import MdConfig
    from molchanica_tpu_torch.md.engine import MdSim
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    eq = np.load(os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                              "eq25k.npz"))
    cfg = MdConfig(lj_cutoff=9.0, coulomb_cutoff=9.0, seed=7)

    def build(c):
        return MdSim(asys.topology, c, eq["x"], box_extent=asys.box_extent,
                     relax=False, device="cuda")

    n = args.iters
    sim = build(cfg)
    trace("clusters, one run", sim, [n], args.every, torch)
    trace("clusters, two runs", sim, [n // 2, n - n // 2], args.every, torch)
    if not args.no_k2:
        trace("cell-grid kernel, one run", build(cfg.replace(
            use_pallas=True)), [n], args.every, torch)


if __name__ == "__main__":
    main()
