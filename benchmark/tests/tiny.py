"""A cell small enough for the CPU: a solvated dipeptide of ~900 sites in a
19 A box, laid out as the benchmark lays out its cells, under a temporary
root."""
from __future__ import annotations

import json
import os

BOX = 19.0


def make_root(tmp, backend="clusters", replicas=2, cutoff=9.0,
              dtype="float32"):
    """(root, bench): a checkout-like tree with one configuration `tiny`,
    one traffic mix `tiny` and one cell `tiny.cell` on `backend` ("clusters"
    or "pallas", K2's plain twin on the CPU)."""
    from benchmark.make_data import write_system
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    root = str(tmp)
    for d in ("configs", "traffic", "checks", "data"):
        os.makedirs(os.path.join(root, "benchmark", d), exist_ok=True)
    asys = build_solvated_protein(n_residues=2, box_side=BOX, seed=1)
    write_system(asys, os.path.join(root, "benchmark", "data", "tiny.npz"))
    grid = 20
    cfg = {
        "name": "tiny", "source": "test", "reduced": [], "assumed": {},
        "system": "benchmark/data/tiny.npz", "start": {},
        "method": "cells_pme", "backend": backend,
        "md": {"integrator": ["langevin_middle", {"gamma": 1.0}],
               "hydrogen_constraint": ["shake", {}], "temp_target": 310.0,
               "lj_cutoff": cutoff, "coulomb_cutoff": cutoff,
               "ewald_rtol": 1e-5, "dtype": dtype,
               "max_init_relaxation_iters": 60,
               "neighbor_rebuild_every": 20,
               "pme_grid": [grid] * 3, "use_pallas": backend == "pallas",
               "seed": 1}}
    traffic = {"replicas": replicas, "dt_ps": 0.002, "steps_per_call": 2,
               "warmup_calls": 1, "profile_steps": 1}
    checks = {"max": {"force_median": 6e-5, "force_median_solute": 2e-2,
                      "force_max_steps": 5e-2, "constraint_error": 1e-4,
                      "temperature_high_K": 1000.0},
              "min": {"temperature_low_K": 50.0}}
    for rel, obj in (("configs/tiny.json", cfg), ("traffic/tiny.json", traffic),
                     ("checks/tiny.cell.json", checks)):
        with open(os.path.join(root, "benchmark", rel), "w") as fh:
            json.dump(obj, fh)
    bench = {"workloads": [{"name": "tiny.cell", "config": "tiny",
                            "traffic": "tiny", "chips": 1, "why": "test"}],
             "end_to_end": [], "per_layer": []}
    return root, bench
