"""How `correct` is decided: two farm steps of the program, taken through
the window's own entry on the window's end state, followed by the plain
float64 reference (benchmark/reference/physics.py) from the same state and
the same random numbers.

Per replica the reference takes the force at the start, runs the
Langevin-middle step with its constraints, takes the force at its own end
state, and steps again from there. The program's four force evaluations of
those two steps (recorded where the farm hands them on: the fresh force of
each step and its integrator's force at the step's end) are compared with
the reference's forces at the same points of its own trajectory. Per
evaluation, with d = |F - F_ref| over the integrated atoms:

  force_median          median d over the median |F_ref|, the largest over
                        the four evaluations
  force_median_solute   the same over the solute alone (the integrated
                        atoms outside the water block: where the bonded,
                        1-4 and X-H constraint terms act)
  force_p99, force_p999 the 99th and 99.9th percentiles over atoms of
                        d / (|F_ref| + the median |F_ref|)
  force_max             the largest of that

all but force_median at the first evaluation, where both sides hold the
same positions (the force alone), and as <name>_steps the largest over
the four; each the largest over replicas. At the end of the two steps

  constraint_error      the largest |r - d| / d over the constraints.

Which of them a cell compares, and their limits, are in
benchmark/checks/<cell>.json; the rest are printed beside them.

The second step starts from the state the first one handed on, so a step
that hands on the wrong state, or none, shows in its forces. The stage the
check skips, the window's trajectory, is held by the kinetic temperature of
every replica at the window's end, inside a band. Position and velocity
gaps are printed as well; float32 rounding sets those.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference.physics import F64, System


STEPS = 2


def capture_steps(farm, dt):
    """farm.step(dt, STEPS) with what it read and made recorded, all on the
    host: x0, v0 [R, N, 3] at its start, the standard normals z [STEPS, R,
    N, 3] it drew, its force evaluations f [2 STEPS, R, N, 3] in order, x1,
    v1 at its end and the energies e [R] it returned."""
    if len(farm._chunks) != 1:
        raise ValueError("the check follows a farm on one device")
    ch = farm._chunks[0]
    sim = farm.sim
    x0, v0 = ch.x.detach().clone(), ch.v.detach().clone()
    gen_state = farm.generator.get_state()
    forces = []
    inner = ch.b.force

    def recorded(*a, **kw):
        out = inner(*a, **kw)
        forces.append(out[0].detach().clone())
        return out

    ch.b.force = recorded
    try:
        e = farm.step(dt, STEPS)
    finally:
        ch.b.force = inner
    if len(forces) != 2 * STEPS:
        raise RuntimeError(f"{STEPS} farm steps made {len(forces)} force "
                           f"evaluations, not {2 * STEPS}")
    g = torch.Generator(device=sim.device)
    g.set_state(gen_state)
    shape = (farm.n,) + tuple(sim.state.positions.shape)
    z = [torch.randn(shape, generator=g, dtype=sim.dtype, device=sim.device)
         for _ in range(STEPS)]
    host = lambda t: t.detach().to("cpu", torch.float32)
    return dict(x0=host(x0), v0=host(v0), z=host(torch.stack(z)),
                f=host(torch.stack(forces)), x1=host(farm.x),
                v1=host(farm.v), e=np.asarray(e, np.float64))


FORCE_NUMBERS = ("force_median", "force_median_solute", "force_p99",
                 "force_p999", "force_max")


def _gaps(f, f_ref, dof, solute):
    """The force numbers of one evaluation (FORCE_NUMBERS, in order)."""
    d_all = torch.linalg.norm(f.to(F64) - f_ref, dim=1)
    mag_all = torch.linalg.norm(f_ref, dim=1)
    d, mag = d_all[dof], mag_all[dof]
    med = mag.median()
    rel = d / (mag + med)
    q = torch.quantile(rel, torch.tensor([0.99, 0.999], dtype=F64,
                                         device=rel.device))
    return (float(d.median() / med),
            float(d_all[solute].median() / mag_all[solute].median()),
            float(q[0]), float(q[1]), float(rel.max()))


def readings(cap, ref: System, dt):
    """Per replica: the reference's view of the captured steps."""
    dev = ref.device
    dof = ref.dof > 0
    solute = ref.solute
    out = []
    for r in range(cap["x0"].shape[0]):
        x = cap["x0"][r].to(dev, F64)
        v = cap["v0"][r].to(dev, F64)
        pairs = ref.pairs(x)
        f_ref, _ = ref.forces(x, pairs)
        gaps = []
        for s in range(STEPS):
            # the step's fresh force, then its integrator's at its end
            gaps.append(_gaps(cap["f"][2 * s, r].to(dev), f_ref, dof,
                              solute))
            x, v = ref.step(x, v, cap["z"][s, r].to(dev), f_ref, dt)
            f_ref, e_ref = ref.forces(x, pairs)
            gaps.append(_gaps(cap["f"][2 * s + 1, r].to(dev), f_ref, dof,
                              solute))
        x1 = cap["x1"][r].to(dev, F64)
        v1 = cap["v1"][r].to(dev, F64)
        # at the start both sides hold the same positions: the force alone;
        # over the four evaluations the step's own gaps come in as well
        row = {k: gaps[0][i] for i, k in enumerate(FORCE_NUMBERS)}
        row.update((k + "_steps", max(g[i] for g in gaps))
                   for i, k in enumerate(FORCE_NUMBERS))
        row["force_median"] = row.pop("force_median_steps")
        out.append(dict(
            row,
            temperature_K=ref.temperature(cap["v0"][r].to(dev)),
            x_gap_A=float(torch.linalg.norm(x1 - x, dim=1)[dof].max()),
            v_gap_A_per_ps=float(torch.linalg.norm(v1 - v, dim=1)[dof].max()),
            energy_gap=abs(float(cap["e"][r]) - e_ref) / abs(e_ref),
            constraint_error=ref.constraint_error(x1)))
        del pairs
    return out


def numbers(per_replica):
    """The numbers compared, over all replicas, and the diagnostics."""
    temps = [p["temperature_K"] for p in per_replica]
    return dict(
        {k: max(p[k] for p in per_replica) for k in per_replica[0]
         if k.startswith("force_")},
        temperature_low_K=min(temps), temperature_high_K=max(temps),
        x_gap_A=max(p["x_gap_A"] for p in per_replica),
        v_gap_A_per_ps=max(p["v_gap_A_per_ps"] for p in per_replica),
        energy_gap=max(p["energy_gap"] for p in per_replica),
        constraint_error=max(p["constraint_error"] for p in per_replica))


def judge(nums, limits):
    """(correct, [[name, value, limit, 'max' | 'min']]): each number
    against its limit; a missing or non-finite number fails."""
    rows = []
    for name, lim in limits["max"].items():
        rows.append([name, nums.get(name), lim, "max"])
    for name, lim in limits.get("min", {}).items():
        rows.append([name, nums.get(name), lim, "min"])
    ok = bool(rows)
    for name, v, lim, kind in rows:
        good = v is not None and math.isfinite(v) and (
            v <= lim if kind == "max" else v >= lim)
        ok = ok and good
    return ok, rows
