#!/usr/bin/env python3
"""Where the time of colpair's CUDA kernel goes, on one CUDA card.

    python3 scripts/colpair_phases.py [--out DIR]

Builds molchanica_tpu_torch/csrc/colpair.cu as it is and three variants
made from it by text substitution at run time (each substitution must
match exactly once, so the script fails loudly when the kernel changes):

  full      the kernel as committed;
  test      the pair test and compaction only: the batch loop runs no
            batch (no pair math, no reductions; the chunk's j reactions,
            all zero, still go to device memory);
  fixed     no chunk at all: block start-up, the zero partials, the part
            sum and the wrapper's output allocations;
  regs128   the kernel as committed with __launch_bounds__(128, 4), so
            ptxas may use up to 128 registers instead of capping them
            where 9 blocks fit per SM by shared memory.

and times each on config 3's L and Q instances (force-only, the main
path's) and the symmetric instance (K1e), as 50 launches captured in one
CUDA graph and replayed (device time, without the wrapper's host cost).
The differences read as: test pass = test - fixed, pair math and
reductions = full - test. Prints ptxas's registers and spills per
variant and the card's name and power limit. The variants' outputs are
wrong by design; only `full` is checked (against the plain version).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "full": [],
    "test": [("for (int b = 0; b < cnt; b += 32) {",
              "for (int b = 0; b < 0; b += 32) {")],
    "fixed": [("for (int e0 = 0; e0 < n; e0 += 32) {",
               "for (int e0 = 0; e0 < 0; e0 += 32) {")],
    "regs128": [("__global__ void __launch_bounds__(THREADS)\n",
                 "__global__ void __launch_bounds__(THREADS, 4)\n")],
}


def instance_table(report):
    """(instance, registers, ptxas's stack and spill line) of each
    colpair_kernel template instance in a ptxas report."""
    import re
    modes, tables = ("lj", "full", "coul"), ("tri", "sym", "cross")
    out, cur, spill = [], None, ""
    for line in report:
        m = re.search(r"colpair_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)ELi(\d)E",
                      line)
        if m:
            mode, we, wf, alch, table = (int(v) for v in m.groups())
            cur = (f"{modes[mode]} {tables[table]}"
                   + (" energy" if we else " force") + (" wf" if wf else "")
                   + (" alch" if alch else ""))
            spill = ""
        elif cur and "spill" in line:
            spill = line
        elif cur and "Used " in line:
            out.append((cur, int(line.split("Used ")[1].split()[0]), spill))
            cur = None
    return out


def instances(torch, np):
    """(kernel, rows, wl, nw, box) of the split engine's force-only L and
    Q instances and the symmetric engine's force-only instance, on
    config 3 from eq25k.npz."""
    from chip_smoke import FIXTURE, engine_instances
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    d = np.load(FIXTURE)
    cfg = MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0), temp_target=310.0,
        lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(), dtype="float32",
        max_init_relaxation_iters=None, neighbor_rebuild_every=20, seed=7)
    out = []
    for tri in (True, False):
        sim = FastSim(asys.topology, cfg, d["x"], box_extent=asys.box_extent,
                      velocities=d["v"], device="cuda", triangular=tri)
        out += [(kern, rows, wl, nw, sim.state.box)
                for kern, rows, wl, nw in engine_instances(sim, torch)
                if not kern.cfg.want_energy]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", metavar="DIR",
                    help="write colpair_phases.json here")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("colpair_phases: no CUDA device")
    sys.path.insert(0, ROOT)
    import tempfile

    from chip_smoke import card_line, graph_ms
    from molchanica_tpu_torch import cuda_build
    from molchanica_tpu_torch.ops import colpair as C

    card = card_line()
    print(f"[card] {card}", flush=True)
    res = dict(card=card, ms={}, ptxas={})
    with tempfile.TemporaryDirectory() as tmp:
        libs = cuda_build.build_variants("colpair.cu", VARIANTS, tmp)
        for name, (_, report) in libs.items():
            res["ptxas"][name] = report
            regs = sorted({int(r.split("Used ")[1].split()[0])
                           for r in report if "Used " in r})
            spills = sorted({r for r in report if "spill" in r
                             and not r.startswith("0 bytes stack")})
            print(f"[ptxas] {name}: registers {regs}; entries with a "
                  f"stack frame or spills: {len(spills)}", flush=True)
            if name == "full":
                for inst, n_reg, spill in instance_table(report):
                    print(f"[ptxas] full {inst}: {n_reg} registers; "
                          f"{spill}", flush=True)
        for kern, rows, wl, nw, box in instances(torch, np):
            pT = rows.T.contiguous()
            params = kern.params(rows.device)
            launch = lambda: C.colpair_cuda(kern.cfg, rows, pT, wl, nw, box,
                                            params)
            cuda_build.load_library = lambda: libs["full"][0]
            f = launch()[0]
            f_p = C.colpair_plain(rows, pT, wl, nw, box, kern.cfg)[0]
            err = float((f - f_p).abs().max() / f_p.abs().max())
            if not err < 1e-4:
                raise SystemExit(f"{kern.name}: full variant against the "
                                 f"plain version {err:.3e}")
            times = {}
            for name in VARIANTS:
                cuda_build.load_library = lambda name=name: libs[name][0]
                times[name] = graph_ms(launch, 50)
            res["ms"][kern.name] = times
            print(f"[phases] {kern.name}: " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in times.items())
                + f"; test pass {times['test'] - times['fixed']:.5f} ms, "
                f"pair math and reductions {times['full'] - times['test']:.5f}"
                f" ms (full vs plain max|dF|/max|F| {err:.2e})", flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "colpair_phases.json"), "w") as fh:
            json.dump(res, fh, indent=1)
    print(json.dumps(res["ms"]))


if __name__ == "__main__":
    main()
