"""A second witness for a cell's force gaps: on the same states, the
force of the cell's own direct-space backend (as the farm hands it on) and
that of another path of the program (by default the other backend, K2 or
the clusters; --same-backend keeps the cell's; --other-dtype float64 runs
it in float64), through MdSim's single-system force path, each against the
plain float64 reference.
Not run by the benchmark's runs:

    python3 benchmark/witness.py --config <c> --traffic <t> --seeds 1,2,3
        [--other-dtype float64] [--same-backend] [--seconds 5] [--worst 6]
        [--out FILE]

The configuration and the traffic mix need not form a cell of
BENCHMARK.json. For each seed a fresh farm runs a short window at the load; the
check's first farm step is captured, and at its start state the gaps of
both backends are read per replica: the check's force numbers, the count
of atoms past 1% and 10% of their force, and the worst atoms of the cell's
backend with the other backend's gap at the same atom, whether they belong
to the solute, and their distance from the nearest face of the box.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stats(f, f_ref, ref, x, worst):
    import torch

    from benchmark.check import FORCE_NUMBERS, _gaps

    dof = ref.dof > 0
    nums = dict(zip(FORCE_NUMBERS, _gaps(f, f_ref, dof, ref.solute)))
    d = torch.linalg.norm(f.double() - f_ref, dim=1)
    mag = torch.linalg.norm(f_ref, dim=1)
    rel = torch.where(dof, d / (mag + mag[dof].median()), 0.0)
    nums["atoms_over_1pct"] = int((rel > 0.01).sum())
    nums["atoms_over_10pct"] = int((rel > 0.1).sum())
    xw = x - ref.box * torch.floor(x / ref.box)
    face = torch.minimum(xw, ref.box - xw).min(1).values
    top = torch.argsort(rel, descending=True)[:worst]
    nums["worst"] = [dict(atom=int(i), rel=float(rel[i]),
                          gap=float(d[i]), f_ref=float(mag[i]),
                          solute=bool(ref.solute[i]),
                          face_A=float(face[i])) for i in top]
    return nums, rel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--worst", type=int, default=6)
    ap.add_argument("--other-dtype")
    ap.add_argument("--same-backend", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import cells, check, harness
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.md.engine import MdSim

    if not torch.cuda.is_available():
        sys.exit("witness: no CUDA card")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    name = f"{a.config}.{a.traffic}"
    bench = {"workloads": [{"name": name, "config": a.config,
                            "traffic": a.traffic, "chips": 1}]}
    run = harness.Run(ROOT, name, seeds[0], "cuda", bench)
    run.setup()
    md = dict(run.config["md"])
    if not a.same_backend:
        md["use_pallas"] = not md["use_pallas"]
    if a.other_dtype:
        md["dtype"] = a.other_dtype
    top = cells.topology(run.arrays, run.statics, run.device)
    other = MdSim(top, cells.md_config(md), run.sim.state.positions.cpu()
                  .numpy(), box_extent=run.box, method=run.config["method"],
                  device=run.device)
    box, couple = other.state.box, other.state.couple
    rows = []
    for seed in seeds:
        if run.farm is None:
            run.start(seed)
        run.window(a.seconds)
        cap = check.capture_steps(run.farm, run.dt)
        run.farm = None
        ref = run.reference()
        for r in range(cap["x0"].shape[0]):
            x = cap["x0"][r].to(run.device)
            xd = x.double()
            f_ref, _ = ref.forces(xd, ref.pairs(xd))
            with torch.no_grad():
                xo = x.to(other.dtype)
                nbr, ovf = other._rebuild_nbr(
                    apply_virtual_sites(xo, other.top), box)
                f_other = other._force_nbr(xo, box, couple, nbr)[0]
            own, rel_own = stats(cap["f"][0, r].to(run.device), f_ref, ref,
                                 xd, a.worst)
            oth, rel_oth = stats(f_other, f_ref, ref, xd, a.worst)
            for w in own["worst"]:
                w["other_rel"] = float(rel_oth[w["atom"]])
            row = dict(seed=seed, replica=r, own=run.sim._nbr_backend,
                       other=f"{other._nbr_backend} {other.dtype}",
                       other_overflow=None if ovf is None else int(ovf),
                       own_numbers=own, other_numbers=oth)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh)


if __name__ == "__main__":
    main()
