#!/usr/bin/env python3
"""Temperature trace of run_sol_sim's stages on the card (methanol in the
35 A OPC box, run_sol_sim's own MdConfig).

    python3 scripts/hydration_farm_trace.py            # the trace
    python3 scripts/hydration_farm_trace.py --run-sol-sim 400 200

The trace builds MdSim as run_sol_sim does (FIRE over 400 iterations),
prints E and T after FIRE, every 100 steps of the two full capped
warm-ups (400 at 0.5 fs, force cap 1000; 400 at 1 fs, cap 3000) and every
50 of --md-steps further MdSim steps at 2 fs, then fans a farm of the 13
HYDRATION_LAMBDAS windows out and prints each replica's T every 20 farm
steps for --farm-steps steps (an overflow ends it with the farm's
message). --run-sol-sim EQUIL [EQUIL ...] instead calls run_sol_sim with
each equil_steps (prod_steps 66, dhdl_interval 10) and prints its wall
time, relaxation path, the T after the warm-ups and per replica at the
end.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 3


def trace(md_steps, farm_steps):
    import numpy as np

    from molchanica_tpu_torch.md.alchemical import HYDRATION_LAMBDAS
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.engine import MdSim
    from molchanica_tpu_torch.molecules.spec import assemble_system
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.parallel.replicas import ReplicaFarm
    from molchanica_tpu_torch.systems.water import OPC

    box = np.array([35.0] * 3)
    mol = methanol()
    mol = mol.translated(box / 2.0 - np.asarray(mol.positions).mean(axis=0))
    asys = assemble_system([mol], box_extent=box, water_model=OPC,
                           alchemical_mol=0, seed=SEED)
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=1.0),
                   temp_target=310.0, lj_cutoff=9.0, coulomb_cutoff=9.0,
                   hydrogen_constraint=HydrogenConstraint.shake(),
                   dtype="float32", max_init_relaxation_iters=400,
                   steps_per_chunk=100, seed=SEED)
    t0 = time.perf_counter()
    sim = MdSim(asys.topology, cfg, asys.positions,
                box_extent=asys.box_extent)
    r = sim.relax_log
    print(f"relax {r['path']} ends {r['block_ends']} kept {r['kept']} "
          f"{time.perf_counter() - t0:.1f}s; E {sim.potential_energy():.1f} "
          f"T {sim.temperature():.1f} M={sim._plan.m_neighbors}", flush=True)
    for dt, cap in ((0.0005, 1000.0), (0.001, 3000.0)):
        for k in range(4):
            sim.step(dt, 100, force_cap=cap)
            print(f"warm dt {dt} after {100 * (k + 1)}: E "
                  f"{float(sim.state.pe_last):.1f} T {sim.temperature():.1f}",
                  flush=True)
    for k in range(md_steps // 50):
        sim.step(0.002, 50)
        print(f"2fs MdSim after {50 * (k + 1)}: E "
              f"{float(sim.state.pe_last):.1f} T {sim.temperature():.1f}",
              flush=True)
    farm = ReplicaFarm(sim, len(HYDRATION_LAMBDAS),
                       couples=1.0 - np.asarray(HYDRATION_LAMBDAS),
                       seed=SEED)
    for k in range(farm_steps // 20):
        try:
            farm.step(0.002, 20)
        except RuntimeError as e:
            print("farm", e, flush=True)
            break
        print(f"farm after {20 * (k + 1)}: T "
              f"{np.round(farm.temperatures(), 1).tolist()}", flush=True)


def sol_sim(equils):
    import numpy as np
    import torch

    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.properties import run_sol_sim

    for equil in equils:
        t0 = time.perf_counter()
        try:
            p = run_sol_sim(methanol(), equil_steps=equil, prod_steps=66,
                            dhdl_interval=10, seed=SEED)
        except RuntimeError as e:
            print(f"equil {equil}: {e}", flush=True)
            continue
        torch.cuda.synchronize()
        rm = p.run_metrics
        print(f"equil {equil} prod 66: {time.perf_counter() - t0:.1f} s, "
              f"relax {rm['relax']['path']}, warm-up T "
              f"{rm['warmup_temperature_K']:.1f}, farm {rm['farm_s']:.1f} s "
              f"over {rm['farm_steps']}, T "
              f"{np.round(rm['temperatures_K'], 1).tolist()}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--md-steps", type=int, default=500)
    ap.add_argument("--farm-steps", type=int, default=200)
    ap.add_argument("--run-sol-sim", type=int, nargs="+", metavar="EQUIL")
    args = ap.parse_args()
    if args.run_sol_sim:
        sol_sim(args.run_sol_sim)
    else:
        trace(args.md_steps, args.farm_steps)


if __name__ == "__main__":
    main()
