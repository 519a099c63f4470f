"""Readings the correctness limits are set from, on the card at a cell's own
size (not run by the benchmark's runs):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--faults constraints_off,bonded_off
        --fault-seeds 4,5,6] [--seconds 5] [--out FILE]

One process builds the cell once; for each seed it starts a fresh farm,
runs a short window at the cell's load and takes the check's numbers. Then
the control: the same program with TF32 switched on for its matrix
products (MdSim turns it off; the step a later change would be tempted to
take for PME's matmul transforms), on --control-seeds. Then each fault of
--faults, planted in the program for the two checked steps only, on
--fault-seeds:

  constraints_off  the farm's step without its SETTLE/SHAKE/RATTLE
  bonded_off       the rest energy without its bonded terms

Each reading goes to standard output as one JSON line, and all of them to
--out.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(fault, farm):
    """The program with `fault` in it, for the length of the block."""
    if fault == "constraints_off":
        saved = []
        for ch in farm._chunks:
            saved.append((ch.b.cp, ch.b.cv))
            ch.b.cp = ch.b.cv = None
            ch._one.clear()
        try:
            yield
        finally:
            for ch, (cp, cv) in zip(farm._chunks, saved):
                ch.b.cp, ch.b.cv = cp, cv
                ch._one.clear()
    elif fault == "bonded_off":
        from molchanica_tpu_torch.md import energy

        inner = energy.bonded_energy

        def off(*a, **kw):
            e, terms = inner(*a, **kw)
            return e * 0.0, terms

        energy.bonded_energy = off
        try:
            yield
        finally:
            energy.bonded_energy = inner
    else:
        raise ValueError(f"no fault {fault!r}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA card")
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    faults = [f for f in a.faults.split(",") if f]
    fault_seeds = [int(s) for s in a.fault_seeds.split(",") if s]
    run = harness.Run(ROOT, a.workload, (seeds or controls or fault_seeds)[0],
                      "cuda")
    t0 = time.perf_counter()
    run.setup()
    print(f"[calibrate] set-up {time.perf_counter() - t0:.1f} s "
          f"{run.split}", file=sys.stderr, flush=True)
    rows = []
    groups = [("sound", seeds), ("control_tf32", controls)]
    groups += [(f, fault_seeds) for f in faults]
    for kind, group in groups:
        tf32 = kind == "control_tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        for seed in group:
            if run.farm is None:
                run.start(seed)
            run.window(a.seconds)
            with (planted(kind, run.farm) if kind in faults
                  else contextlib.nullcontext()):
                ok, failed, _, nums, per = run.check(free=False)
            row = dict(kind=kind, seed=seed, correct=ok, failed=failed,
                       farm_steps=run.window_steps, numbers=nums,
                       per_replica=per, check_s=run.check_seconds)
            rows.append(row)
            print(json.dumps(row), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh)


if __name__ == "__main__":
    main()
