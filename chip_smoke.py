#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (molchanica_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on lines of its own:
  1. the card (nvidia-smi name and power limit) and torch's CUDA version;
  2. build of the hand-written kernels from csrc/ (one nvcc, sm_90a);
  3. the ~25k-site solvated polyalanine (config 3 of BASELINE.md) from the
     port's own builder, started from the committed eq25k.npz fixture, in
     FastSim with the benchmark's MdConfig;
  4. kernel parity: on the real L and Q subset tables after the first
     rebuild, every colpair instance the path runs (L/Q x force-only/
     energy) against its plain torch version on the same inputs;
  5. the FastSim path: a sim.step() warm-up and one timed call, then
     sim.potential_energy(); kernel launch counts over exactly that run;
  6. FastSim engine parity: the whole force of a fresh engine on the card
     against the same engine on the CPU (plain kernel twin), on the same
     state, through both force functions the path runs: force-only (the
     K-poly kernels of every step) and with energies (its terms too);
  7. MdSim on the same system, state and MdConfig plus use_pallas=True
     (method cells_pme, the cell-grid kernel K2): construction;
  8. K2 parity: on the real cell grid after the first rebuild, the CUDA
     kernel against its plain torch version on the same center rows and
     ghost array;
  9. the MdSim path: a warm-up call and one timed call; K2 launch counts
     over exactly those calls, against force_evals and against
     n + ceil(n/20) + 1 per call;
 10. MdSim engine parity: force_fn on the card against the same MdSim on
     the CPU, on the initial state;
 11. the hydration system: methanol from the committed MolSpec
     (systems/data/methanol_gaff2.json) as the coupled molecule in a
     35 A OPC box, in FastSim with run_sol_sim_fast's MdConfig;
 12. K1d parity: on its real L and Q tables after the first rebuild,
     every has_alch colpair instance (L 'full' / Q 'coul' + water filter
     x force-only / energy) against its plain torch version, at couple
     0.5 and 0.05;
 13. alchemical engine parity at couple 0.5: the card's FastSim against
     the same engine on the CPU on one state (after a minimize on the
     card), force-only and energy force functions and dhdl;
 14. the TI path: run_sol_sim_fast on the card at the full box and all 13
     HYDRATION_LAMBDAS windows, shortened (--ti-equil, --ti-prod); K1d
     launch counts over exactly that call, against its force_evals;
 15. K1c: FastSim(per_slice_k=0) on config 3 at the same state (range
     tables); each range instance it runs (L/Q x force-only/energy)
     against its plain torch version on the real tables, then a warm-up
     and a timed step call (--range-warm, --range-steps) with launches
     counted against its force evaluations;
 16. K1f: the sharded colpair on config 3 (per-site sort, range tables,
     every site its own exclusion group): 8 ranks spawned on the one card
     over gloo (parallel/launch.py); on every rank the shard kernel
     against its plain version on the rank's local inputs, then
     --shard-calls sharded calls (energy and force-only) with launches
     counted per rank; the assembled forces and energies against the
     single-device K1c kernel on the same sorted state;
 17. parallel/dryrun.py::dryrun_multidevice(4, "gloo", "cuda");
 18. the kernel JSON line, the card line, and the final JSON result line.
An NVT hold (the mean temperature of further FastSim steps near 310 K)
runs only when --hold N asks for it.

Kernel parity is held to two gates. The whole-array one: max|dF|/max|F|
< 1e-4 and total energies rel < 1e-5. And one scaled per site: a force
error against the sum, over that site's pairs, of the magnitudes of the
terms each pair force is made of, an energy error against the same sum
over its i-cluster's (K1) or cell's (K2) pair energies (colpair_parity,
direct_force_parity). Excluded solute pairs enter the kernels at ~1e5
kcal/mol/A and are subtracted again, so the whole-array ratio alone would
let an error of a whole site force through everywhere else.

Fails (non-zero exit, no result line) without a CUDA device, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "molchanica_tpu", "systems", "data",
                       "eq25k.npz")
# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations per evaluated pair of csrc/colpair.cu (an FMA counts 2,
# rsqrt/exp/min/max 1): geometry, r^2 clamp and force accumulation 20, LJ
# with the C1 clamp 23, K-poly Coulomb 31 (degree 12), erfcx Coulomb 38,
# energy accumulation 4 (LJ) and 3 (Coulomb)
PAIR_OPS = {
    ("full", False): 20 + 23 + 31, ("coul", False): 20 + 31,
    ("lj", False): 20 + 23, ("full", True): 20 + 23 + 38 + 4 + 3,
    ("coul", True): 20 + 38 + 3, ("lj", True): 20 + 23 + 4,
}
# the has_alch instances (same counting): the softcore prelude (is_alch,
# alch, a_lj, soft_c, rsqrt(r2s + soft_c)) 14, Beutler LJ 23 + 7, erfcx
# Coulomb with the softcore force 38 + 5; never K-poly
PAIR_OPS_ALCH = {
    ("full", False): 20 + 14 + 30 + 43, ("coul", False): 20 + 14 + 43,
    ("full", True): 20 + 14 + 30 + 43 + 4 + 3,
    ("coul", True): 20 + 14 + 43 + 3,
}
# FP32 operations per in-cutoff pair of csrc/direct_force.cu (same
# counting): geometry and r^2 clamp 10, softcore LJ with the clip 38, A&S
# Coulomb 30, force accumulation 7
K2_PAIR_OPS = 10 + 38 + 30 + 7
N_TIMED = 1000
N_WARM = 200
N_MD_TIMED = 200
N_MD_WARM = 40
# kernel vs plain, whole arrays: max|dF| / max|F| and total energy rel
KERNEL_TOL_F_MAX, KERNEL_TOL_E_TOT = 1e-4, 1e-5
# kernel vs plain, two float32 evaluations, per site and per i-cluster
# (colpair_parity). The plain version's own float32 floor against float64
# is at most 1.1e-6 and 6.6e-7 (tests/test_torch_colpair.py); a 1e-3 error
# in water O's LJ well depth gives 7e-4.
KERNEL_TOL_F, KERNEL_TOL_E = 1e-5, 1e-5
# engine card vs CPU, per site: 1e-4 of max|F| (PME, bonded and autograd
# sums) plus 1e-5 of the site's direct-space scale (colpair_plain's f_abs)
ENGINE_TOL_F, ENGINE_TOL_DIRECT = 1e-4, 1e-5
# the hydration phases: reference protocol box and lambda list, windows
# shortened to N_TI_EQUIL + N_TI_PROD steps with a dH/dlambda sample every
# TI_DHDL_INTERVAL; K1d held at two couplings where the softcore is large
TI_SEED = 3
N_TI_EQUIL = 40
N_TI_PROD = 60
TI_DHDL_INTERVAL = 20
ALCH_COUPLES = (0.5, 0.05)
# dhdl is a float32 central difference (h = 1e-3): card vs CPU within
# DHDL_FLOORS x eps32 * sum|terms| / 2h (the CPU tests hold the port to
# the JAX package within 4; the card sums in other orders, with atomics)
DHDL_H = 1e-3
DHDL_FLOORS = 8.0
# |<dH/dlambda>| per window above this is a blow-up (kcal/mol): a CPU
# rehearsal of phase 14 (24 A box, 6 A cutoff, same windows) stayed under
# 30 at every lambda, and so did this phase on an H100 (under 16); the
# run before the softcore fix (docs/TI_SHOWCASE.json) integrated to +1218
# kcal/mol
DHDL_BLOWUP = 500.0
# the range-table FastSim (phase 15) and the sharded colpair (phase 16):
# ranks on the one card, and sharded calls per variant. The assembled
# forces are held to 1e-4 of max|F| (the JAX package's 25k bound) and,
# per site and per i-cluster, to the kernel gates above
N_RANGE_WARM = 20
N_RANGE_STEPS = 100
N_SHARD = 8
N_SHARD_CALLS = 20
SHARD_TOL_F_MAX = 1e-4


def say(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n):
    """Mean device ms of fn() over n calls, after one warm call."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def kernel_parity(sim, torch, couples=(None,)):
    """Each colpair instance of the path vs colpair_plain on the state's
    tables, at each coupling in `couples` (None: the state's own, for the
    instances without has_alch); timed at the first. Returns one JSON
    kernel entry per instance, with the worst errors over `couples`."""
    from molchanica_tpu_torch.ops.colpair import (ICL, colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain)

    st = sim.state
    sp = st.split
    dev = st.x.device
    x_ext = torch.cat([st.x, torch.full((1, 3), 1.0e6, device=dev)])
    cpls = [st.couple if c is None else
            torch.tensor(c, dtype=torch.float32, device=dev) for c in couples]
    entries = []
    for key in ("l", "q"):
        rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
        pT = rows.T.contiguous()
        wl, nw = sp[f"wl_{key}"], sp[f"nw_{key}"]
        S = rows.shape[0]
        for we in (False, True):
            kern = sim._split["kernels"][we][key.upper()]
            worst = dict(err=0.0, rel_f=0.0, rel_e=0.0)
            for c, cpl in zip(couples, cpls):
                f_k, e_k = colpair_cuda(kern.cfg, rows, pT, wl, nw, st.box,
                                        kern.params(dev), cpl)
                stats = {}
                f_p, elj_p, ec_p = colpair_plain(rows, pT, wl, nw, st.box,
                                                 kern.cfg, cpl, stats=stats)
                torch.cuda.synchronize()
                rel_f, rel_e = colpair_parity(f_k, e_k.sum(1), f_p, stats)
                err = float((f_k - f_p).abs().max())
                f_max = float(f_p.abs().max())
                e_kern = float(e_k.sum())
                e_plain = float(elj_p + ec_p)
                rel_tot = abs(e_kern - e_plain) / max(abs(e_plain), 1e-30)
                at = "" if c is None else f" couple={c:g}"
                say(f"[parity] {kern.name}{at} S={S} NC={S // ICL} "
                    f"max_entries={int(nw.max())} pairs={stats['pairs']} "
                    f"max|dF|/max|F|={err / f_max:.3e} (max|dF|={err:.4e}, "
                    f"max|F|={f_max:.4e}) e_kernel={e_kern:.6f} "
                    f"e_plain={e_plain:.6f} rel_e={rel_tot:.3e} "
                    f"(limits {KERNEL_TOL_F_MAX:g}, {KERNEL_TOL_E_TOT:g})")
                say(f"[parity] {kern.name}{at} per site max|dF|/scale="
                    f"{rel_f:.3e}, per cluster |dE|/scale={rel_e:.3e} "
                    f"(limits {KERNEL_TOL_F:g}, {KERNEL_TOL_E:g})")
                if not (err / f_max < KERNEL_TOL_F_MAX
                        and rel_tot < KERNEL_TOL_E_TOT
                        and rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E):
                    raise SystemExit(f"{kern.name}{at}: kernel and plain "
                                     "disagree")
                worst = dict(err=max(worst["err"], err),
                             rel_f=max(worst["rel_f"], rel_f),
                             rel_e=max(worst["rel_e"], rel_e))
            ms = cuda_ms(lambda: kern(rows, pT, wl, nw, st.box, cpls[0]),
                         50)
            plain_ms = cuda_ms(lambda: colpair_plain(
                rows, pT, wl, nw, st.box, kern.cfg, cpls[0]), 3)
            table = PAIR_OPS_ALCH if kern.cfg.has_alch else PAIR_OPS
            ops = stats["pairs"] * table[(kern.cfg.mode, we)]
            nbytes = (rows.numel() + pT.numel() + wl.numel() + nw.numel()
                      + 3 + 64 + int(kern.cfg.has_alch)) * 4 \
                + (S * 3 + (S // ICL) * 2) * 4
            t_ops = ops / PEAK_FP32 * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            entries.append(dict(
                name=kern.name, route="cuda",
                source="molchanica_tpu_torch/csrc/colpair.cu",
                replaces="molchanica_tpu/ops/pallas/colpair.py:810",
                launches=0, max_abs_err=worst["err"], ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, pairs=stats["pairs"], S=S,
                site_rel_err=worst["rel_f"],
                cluster_rel_err_e=worst["rel_e"]))
            say(f"[time] {kern.name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.5f} ms "
                f"({entries[-1]['bound_by']})")
    return entries


def engine_parity(build, torch, lam=None, tag="engine"):
    """The card's force against the CPU engine's on the same state, for the
    force-only function (the K-poly kernels of every step; with a coupled
    solute, the erfcx has_alch kernels) and the one with energies (whose
    terms must agree to rel 1e-5 too). Per site the limit is ENGINE_TOL_F
    of max|F| plus ENGINE_TOL_DIRECT of the site's direct-space scale (the
    plain kernels' f_abs, owned and spread like the force): excluded solute
    pairs enter the kernel at ~1e5 kcal/mol/A and are subtracted again,
    which leaves a float32 floor at those sites only (see
    tests/test_torch_fast_engine.py). With `lam`, both engines are set to
    that lambda window and dhdl must agree within DHDL_FLOORS of its
    float32 floor. Returns the card's dhdl (or None)."""
    import numpy as np

    from molchanica_tpu_torch.ops.colpair import colpair_plain

    t0 = time.perf_counter()
    sim = build("cuda")
    cpu = build("cpu")
    if lam is not None:
        sim.configure_alchemical_window(lam)
        cpu.configure_alchemical_window(lam)
    st_c = cpu.state
    st_g = sim.state.replace(x=st_c.x.to(sim.device))
    if not torch.equal(sim.state.perm.cpu(), st_c.perm):
        raise SystemExit("engine parity: CPU and card sorts differ")
    sp = st_c.split
    with torch.no_grad():
        x_v = cpu._apply_vsites(st_c.x, st_c.vm_of, st_c.box)
        x_ext = torch.cat([x_v, torch.full((1, 3), 1.0e6)])
        f_abs = []
        for key in ("l", "q"):
            rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
            stats = {}
            colpair_plain(rows, rows.T.contiguous(), sp[f"wl_{key}"],
                          sp[f"nw_{key}"], st_c.box,
                          cpu._split["kernels"][False][key.upper()].cfg,
                          st_c.couple, stats=stats)
            f_abs.append(stats["f_abs"])
        comb = torch.cat([*f_abs, torch.zeros(1)])
        a = (comb[sp["gsrc_l"]] + comb[sp["gsrc_q"]])[:, None].repeat(1, 3)
        a = cpu._spread_vsite_forces(a, st_c.vm_of)[:, 0]
        for we in (False, True):
            fg, (_, tg) = sim._make_force_fn(we)(st_g.x, st_g)
            fc, (_, tc) = cpu._make_force_fn(we)(st_c.x, st_c)
            err = (fg.cpu() - fc).abs().amax(dim=1)
            f_max = float(fc.abs().max())
            tol = ENGINE_TOL_F * f_max + ENGINE_TOL_DIRECT * a
            worst = int(torch.argmax(err / tol))
            terms = ("bond", "angle", "dihedral", "recip") + (
                ("lj", "coulomb") if we else ()) + (
                ("comp",) if "comp" in tc else ())
            worst_e = max(abs(float(tg[k]) - float(tc[k]))
                          / max(abs(float(tc[k])), 1e-30) for k in terms
                          if float(tc[k]) != 0.0 or float(tg[k]) != 0.0)
            say(f"[{tag}] {'energy' if we else 'force-only'}: card vs CPU "
                f"on one state: max|dF|={float(err.max()):.4f} "
                f"(max|F|={f_max:.2f}); worst site {worst}: |dF|="
                f"{float(err[worst]):.4f} against limit "
                f"{float(tol[worst]):.4f} (direct scale "
                f"{float(a[worst]):.4e}); worst energy term rel "
                f"{worst_e:.2e}")
            if not (bool((err <= tol).all()) and worst_e < 1e-5):
                raise SystemExit(f"{tag} parity failed")
        d_g = d_c = None
        if lam is not None:
            sim.state = st_g
            d_g, d_c = sim.dhdl(), cpu.dhdl()
            floor = float(np.finfo(np.float32).eps) * sum(
                abs(float(tc[k])) for k in ("bond", "angle", "dihedral",
                                            "recip", "lj", "coulomb")) \
                / (2.0 * DHDL_H)
            say(f"[{tag}] dhdl at lambda={lam:g}: card {d_g:.4f} CPU "
                f"{d_c:.4f} kcal/mol, |diff| {abs(d_g - d_c):.4f} against "
                f"{DHDL_FLOORS:g} x float32 floor {floor:.4f}; comp term "
                f"card {float(tg['comp']):.6f} CPU {float(tc['comp']):.6f}")
            if not (np.isfinite(d_g)
                    and abs(d_g - d_c) <= DHDL_FLOORS * floor):
                raise SystemExit(f"{tag}: dhdl parity failed")
    say(f"[{tag}] CPU engine and checks {time.perf_counter() - t0:.1f} s")
    return d_g


def k2_parity(md, torch):
    """K2 (csrc/direct_force.cu) against direct_force_plain on the cell
    grid of the state after its first rebuild. Returns its JSON entry."""
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.ops.direct_force import (cell_energies,
                                                       direct_force_cuda,
                                                       direct_force_parity,
                                                       direct_force_plain)

    s = md.state
    plan, direct = md._plan, md._direct
    xv = apply_virtual_sites(s.positions, md.top)
    sa, _, ovf = md._rebuild(xv, s.box)
    center, ghost = direct.inputs(xv, s.box, sa)
    args = (s.couple, md._beta)
    out_k = direct_force_cuda(plan, center, ghost, *args)
    stats = {}
    out_p = direct_force_plain(center, ghost, direct.starts, *args,
                               direct.rc2, stats=stats)
    torch.cuda.synchronize()
    e_k = cell_energies(out_k, plan.n_cells)
    e_p = cell_energies(out_p, plan.n_cells)
    rel_f, rel_e = direct_force_parity(out_k[:, :3], e_k.sum(1),
                                       out_p[:, :3], stats)
    err = float((out_k[:, :3] - out_p[:, :3]).abs().max())
    f_max = float(out_p[:, :3].abs().max())
    tot_k, tot_p = float(e_k.sum()), float(e_p.sum())
    rel_tot = abs(tot_k - tot_p) / max(abs(tot_p), 1e-30)
    S = center.shape[0]
    say(f"[parity] direct_force cells={plan.n_cells} C={plan.capacity} "
        f"S={S} G={ghost.shape[1]} overflow={int(ovf)} "
        f"pairs={stats['pairs']} slots={S * 9 * 3 * plan.capacity} "
        f"max|dF|/max|F|={err / f_max:.3e} (max|dF|={err:.4e}, "
        f"max|F|={f_max:.4e}) e_kernel={tot_k:.6f} e_plain={tot_p:.6f} "
        f"rel_e={rel_tot:.3e} (e_lj {float(e_k[:, 0].sum()):.4f} / "
        f"{float(e_p[:, 0].sum()):.4f}, e_c {float(e_k[:, 1].sum()):.4f} / "
        f"{float(e_p[:, 1].sum()):.4f})")
    say(f"[parity] direct_force per slot max|dF|/scale={rel_f:.3e}, per "
        f"cell |dE|/scale={rel_e:.3e} (limits {KERNEL_TOL_F:g}, "
        f"{KERNEL_TOL_E:g}; total energy {KERNEL_TOL_E_TOT:g})")
    if not (rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E
            and rel_tot < KERNEL_TOL_E_TOT):
        raise SystemExit("direct_force: kernel and plain disagree")
    ms = cuda_ms(lambda: direct_force_cuda(plan, center, ghost, *args), 20)
    plain_ms = cuda_ms(lambda: direct_force_plain(
        center, ghost, direct.starts, *args, direct.rc2), 3)
    t_ops = stats["pairs"] * K2_PAIR_OPS / PEAK_FP32 * 1e3
    nbytes = (center.numel() + ghost.numel() + 2 + out_k.numel()) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    entry = dict(
        name="direct_force", route="cuda",
        source="molchanica_tpu_torch/csrc/direct_force.cu",
        replaces="molchanica_tpu/ops/pallas/direct_force.py:156",
        launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, pairs=stats["pairs"], S=S, bytes=nbytes,
        site_rel_err=rel_f, cell_rel_err_e=rel_e, rel_e_total=rel_tot)
    say(f"[time] direct_force: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {entry['bound_ms']:.5f} ms ({entry['bound_by']}; "
        f"{stats['pairs']} pairs x {K2_PAIR_OPS} FP32 ops, {nbytes} bytes)")
    return entry


def md_path(md, calls, torch, np):
    """The MdSim path: md.step(0.002, n) for each n in calls, K2 launches
    counted over exactly those calls; the last call timed."""
    from molchanica_tpu_torch.ops.direct_force import DirectForce

    dt = 0.002
    k = md.cfg.neighbor_rebuild_every
    DirectForce.launches = 0
    evals0 = md.force_evals
    for n in calls[:-1]:
        t0 = time.perf_counter()
        md.step(dt, n)
        torch.cuda.synchronize()
        say(f"[md] warm-up {n} steps in {time.perf_counter() - t0:.1f} s")
    n = calls[-1]
    t0 = time.perf_counter()
    md.step(dt, n)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = DirectForce.launches
    n_eval = md.force_evals - evals0
    expected = sum(c + -(-c // k) + 1 for c in calls)
    ms_step = elapsed / n * 1e3
    ns_day = n * dt / 1000.0 / elapsed * 86400.0
    t_final = md.temperature()
    x = md.state.positions
    finite = bool(torch.isfinite(x).all())
    ovf = int(md._rebuild(x, md.state.box)[2])
    say(f"[md] n={n} ms/step={ms_step:.4f} ns/day={ns_day:.3f} "
        f"T={t_final:.2f} K E_pot(last)={float(md.state.pe_last):.3f} "
        f"kcal/mol finite={finite} overflow={ovf} C={md._plan.capacity}")
    say(f"[md] direct_force launches {launches}, force_evals {n_eval}, "
        f"expected {expected} (n + ceil(n/{k}) + 1 over calls {calls})")
    if not finite or not 100.0 < t_final < 600.0:
        raise SystemExit(f"unstable MdSim run: finite={finite} T={t_final}")
    if not launches == n_eval == expected:
        raise SystemExit(f"direct_force launches {launches} / force_evals "
                         f"{n_eval} != {expected}")
    return dict(ms_per_step=ms_step, ns_per_day=ns_day,
                temperature_K=t_final, elapsed_s=elapsed, n_timed=n,
                launches=launches)


def md_engine_parity(build_md, torch):
    """MdSim.force_fn on the card against the same MdSim on the CPU, on the
    CPU engine's initial state. Per site the limit is ENGINE_TOL_F of
    max|F| plus ENGINE_TOL_DIRECT of the site's direct-space scale; every
    energy term within rel 1e-5, for lj and coulomb of |ref| plus the
    kernel's |e| sums (MdSim.direct_space_scales): those hold the excluded
    solute pairs that are subtracted again."""
    t0 = time.perf_counter()
    md_g = build_md("cuda")
    md_c = build_md("cpu")
    x_c = md_c.state.positions
    sg, sc = md_g.state, md_c.state
    fg, (_, tg) = md_g.force_fn(x_c.to(md_g.device), sg.box, sg.couple)
    fc, (_, tc) = md_c.force_fn(x_c, sc.box, sc.couple)
    a, e_scale = md_c.direct_space_scales(x_c)
    err = (fg.cpu() - fc).abs().amax(dim=1)
    f_max = float(fc.abs().max())
    tol = ENGINE_TOL_F * f_max + ENGINE_TOL_DIRECT * a
    worst = int(torch.argmax(err / tol))
    worst_e, worst_k = 0.0, ""
    for k in ("bond", "angle", "dihedral", "recip", "lj", "coulomb"):
        ref = float(tc[k])
        rel = abs(float(tg[k]) - ref) / (abs(ref) + e_scale.get(k, 0.0))
        say(f"[md-engine] {k}: card {float(tg[k]):.6f} cpu {ref:.6f} "
            f"rel {rel:.2e}")
        if rel > worst_e:
            worst_e, worst_k = rel, k
    say(f"[md-engine] card vs CPU on the init state: max|dF|="
        f"{float(err.max()):.4f} (max|F|={f_max:.2f}); worst site {worst}: "
        f"|dF|={float(err[worst]):.4f} against limit "
        f"{float(tol[worst]):.4f} (direct scale {float(a[worst]):.4e}); "
        f"worst energy term {worst_k} rel {worst_e:.2e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not (bool((err <= tol).all()) and worst_e < 1e-5):
        raise SystemExit("MdSim engine parity failed")


def hydration_system(torch, np):
    """Phase 11: methanol as the coupled molecule in the reference
    protocol's 35 A OPC box, with run_sol_sim_fast's MdConfig; the card's
    FastSim on it (velocities from the engine's seeded generator)."""
    from molchanica_tpu_torch.md.alchemical import HYDRATION_BOX_SIDE
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.properties.water_sol import hydration_setup

    t0 = time.perf_counter()
    asys, cfg = hydration_setup(methanol(), HYDRATION_BOX_SIDE,
                                seed=TI_SEED)
    t1 = time.perf_counter()
    sim = FastSim(asys.topology, cfg, asys.positions,
                  box_extent=asys.box_extent, device="cuda")
    torch.cuda.synchronize()
    sp = sim._split
    say(f"[hyd] methanol in a {HYDRATION_BOX_SIDE:g} A OPC box: "
        f"{asys.topology.n_atoms_real} sites ({asys.n_waters} waters), "
        f"{sim.n_base} padded, built in {t1 - t0:.1f} s; FastSim init "
        f"{time.perf_counter() - t1:.1f} s: S={sim.S} S_L={sp['S_L']} "
        f"S_Q={sp['S_Q']} cols={sim.plan.nx}x{sim.plan.ny} "
        f"pme={tuple(sim._recip.K)} coupled={int(asys.topology.couple_mask.sum())} "
        f"intramol pairs={int(sim._im_mask.sum())} "
        f"E_pot(init)={float(sim.state.pe_last):.3f} kcal/mol")
    if not sim._has_alch:
        raise SystemExit("hydration system: no coupled atoms")
    return asys, cfg, sim


def ti_path(n_equil, n_prod, torch, np):
    """Phase 14: run_sol_sim_fast(methanol) on the card at the full box and
    lambda list; K1d launches counted over exactly that call. Returns
    (summary dict, launch counts)."""
    from molchanica_tpu_torch.md.alchemical import HYDRATION_LAMBDAS
    from molchanica_tpu_torch.molecules.spec_json import methanol
    from molchanica_tpu_torch.ops.colpair import ColpairDirect
    from molchanica_tpu_torch.properties import run_sol_sim_fast

    ColpairDirect.launches.clear()
    t0 = time.perf_counter()
    props = run_sol_sim_fast(methanol(), equil_steps=n_equil,
                             prod_steps=n_prod,
                             dhdl_interval=TI_DHDL_INTERVAL, seed=TI_SEED,
                             device="cuda")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = dict(ColpairDirect.launches)
    rm = props.run_metrics
    n_eval = rm["force_evals"]
    n_samples = -(-n_prod // TI_DHDL_INTERVAL)
    n_win = len(HYDRATION_LAMBDAS)
    # init 1, minimize(300) 300 + 15, warm-up 400, window steps, 2 per dhdl
    expected = 1 + 315 + 400 + n_win * (n_equil + n_prod + 2 * n_samples)
    ms_step = rm["window_step_s"] / rm["window_steps"] * 1e3
    for w in props.windows:
        say(f"[ti] lambda={w.lam:.2f} <dH/dl>={w.mean:10.4f} kcal/mol "
            f"samples={np.array2string(w.dhdl_samples, precision=3)}")
    say(f"[ti] dG_hydration={props.dg_hydration_kcal:.4f} kcal/mol "
        f"SEM={props.dg_sem_kcal:.4f} (not converged: {n_prod} production "
        f"steps per window) contacts={props.mean_n_water_contacts:.2f} "
        f"h_bonds={props.mean_n_h_bonds:.2f} "
        f"coupled <dH/dl>={props.mean_coupled_interaction_kcal:.4f}")
    say(f"[ti] {n_win} windows x ({n_equil} + {n_prod}) steps: "
        f"{ms_step:.4f} ms/step over {rm['window_steps']} window steps; "
        f"T={rm['temperature_K']:.2f} K after the last window; the call "
        f"took {elapsed:.1f} s")
    total = sum(counts.values())
    say(f"[ti] colpair launches {total} (expected 2 x {n_eval} force "
        f"evaluations; {expected} evaluations without replans): {counts}")
    bad = [w.lam for w in props.windows
           if len(w.dhdl_samples) != n_samples
           or not np.isfinite(w.dhdl_samples).all()
           or not abs(w.mean) < DHDL_BLOWUP]
    if bad or len(props.windows) != n_win:
        raise SystemExit(f"TI path: windows {bad} lack {n_samples} finite "
                         f"samples or exceed |<dH/dl>| < {DHDL_BLOWUP:g}")
    if not np.isfinite(props.dg_hydration_kcal):
        raise SystemExit("TI path: non-finite dG")
    if not 100.0 < rm["temperature_K"] < 600.0:
        raise SystemExit(f"TI path: T={rm['temperature_K']} K")
    alch = [k for k in counts if "_alch_" in k]
    if total != 2 * n_eval or len(alch) != len(counts) or n_eval < expected:
        raise SystemExit(f"TI path: launches {counts} != 2 x {n_eval}")
    return dict(ms_per_step=ms_step, elapsed_s=elapsed,
                temperature_K=rm["temperature_K"],
                dg_hydration_kcal=props.dg_hydration_kcal,
                dg_sem_kcal=props.dg_sem_kcal, force_evals=n_eval,
                windows=[dict(lam=w.lam, samples=w.dhdl_samples.tolist())
                         for w in props.windows]), counts


def range_path(build0, n_warm, n_steps, torch, np):
    """Phase 15: FastSim(per_slice_k=0) on config 3. Its four range
    instances against their plain versions, then step(0.002, n_warm), a
    timed step(0.002, n_steps) and potential_energy(), launches counted
    over exactly those calls. Returns (kernel entries, summary)."""
    from molchanica_tpu_torch.ops.colpair import ColpairDirect

    t0 = time.perf_counter()
    sim = build0()
    torch.cuda.synchronize()
    sp = sim._split
    say(f"[range] FastSim(per_slice_k=0) init {time.perf_counter() - t0:.1f}"
        f" s: psk={sim._psk} wl_l {tuple(sim.state.split['wl_l'].shape)} "
        f"wl_q {tuple(sim.state.split['wl_q'].shape)} (w_max "
        f"{sp['plan_L'].w_max}), max entries L "
        f"{int(sim.state.split['nw_l'].max())} Q "
        f"{int(sim.state.split['nw_q'].max())}")
    if sim._psk != 0 or sim.state.split["wl_l"].shape[1] != \
            3 * sp["plan_L"].w_max:
        raise SystemExit("FastSim(per_slice_k=0) did not build range tables")
    entries = kernel_parity(sim, torch)
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    t0 = time.perf_counter()
    sim.step(0.002, n_warm)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim.step(0.002, n_steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    e_pot = sim.potential_energy()
    counts = dict(ColpairDirect.launches)
    n_eval = sim.force_evals - evals0
    t_final = sim.temperature()
    finite = bool(np.isfinite(sim.positions_unsorted()).all())
    ms_step = elapsed / n_steps * 1e3
    say(f"[range] warm-up {n_warm} steps {t1 - t0:.1f} s; n={n_steps} "
        f"ms/step={ms_step:.4f} T={t_final:.2f} K E_pot={e_pot:.3f} "
        f"kcal/mol finite={finite} overflow={int(sim.state.overflow)}")
    say(f"[range] colpair launches {sum(counts.values())} (expected 2 x "
        f"{n_eval} force evaluations): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not finite or not 100.0 < t_final < 600.0 or not np.isfinite(e_pot):
        raise SystemExit(f"range-table run: finite={finite} T={t_final}")
    if sum(counts.values()) != 2 * n_eval or any(
            e["launches"] == 0 or "_range_" not in e["name"]
            for e in entries):
        raise SystemExit(f"range-table launches {counts} != 2 x {n_eval}")
    return entries, dict(ms_per_step=ms_step, temperature_K=t_final,
                         n_timed=n_steps, force_evals=n_eval)


def shard_rank(rank, n_dev, device, plan, halo, rows, wl, nw, box, n_calls):
    """One rank of phase 16 (spawned by parallel/launch.py). For the energy
    and the force-only sharded colpair: the rank's K1f launch against its
    plain version on the rank's local inputs, both timed with CUDA events
    while the other ranks wait (the card's time is shared between the
    processes' contexts), then n_calls sharded calls on all ranks at once
    with the launches counted (host clock, exchange included), the
    exchange alone, and the gathered results."""
    import torch
    import torch.distributed as dist

    from molchanica_tpu_torch.ops.colpair import (ColpairDirect, colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain)
    from molchanica_tpu_torch.parallel.spatial_colpair import (
        block, make_sharded_colpair_direct)

    to = lambda t: block(t, rank, n_dev).to(device).contiguous()
    rows_b, wl_b, nw_b = to(rows), to(wl), to(nw)
    box = box.to(device)
    couple = torch.ones((), device=device)
    out = dict(rank=rank, device=str(device))

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_calls):
            r = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_calls * 1e3, r

    for we in (True, False):
        sh = make_sharded_colpair_direct(None, plan, halo, want_energy=we,
                                         device=device)
        kern = sh.kernel
        i_base = halo * sh.B
        pT, wl_loc = sh.local_inputs(rows_b, wl_b)
        f_i, f_j, e = colpair_cuda(kern.cfg, rows_b, pT, wl_loc, nw_b, box,
                                   kern.params(device), couple, i_base=i_base)
        stats = {}
        p_i, p_j, elj_p, ec_p = colpair_plain(rows_b, pT, wl_loc, nw_b, box,
                                              kern.cfg, couple, stats=stats,
                                              i_base=i_base)
        torch.cuda.synchronize()

        def sites(a_i, a_j):
            """This rank's force on each local j slot: the own block's
            slots take their i-forces and their reactions together."""
            s = a_j.clone()
            s[i_base:i_base + a_i.shape[0]] += a_i
            return s

        n_i = rows_b.shape[0]
        f_k, f_p = sites(f_i, f_j), sites(p_i, p_j)
        stats["f_abs"] = sites(stats["f_abs"][:n_i], stats["f_abs"][n_i:])
        rel_f, rel_e = colpair_parity(f_k, e.sum(1), f_p, stats)
        err = float((f_k - f_p).abs().max())
        e_k, e_p = float(e.sum()), float(elj_p + ec_p)
        for r in range(n_dev):              # one rank on the card at a time
            dist.barrier()
            if r == rank:
                ms = cuda_ms(lambda: kern(rows_b, pT, wl_loc, nw_b, box,
                                          couple), 20)
                plain_ms = cuda_ms(lambda: colpair_plain(
                    rows_b, pT, wl_loc, nw_b, box, kern.cfg, couple,
                    i_base=i_base), 3)
        e_cluster = sh.comm.all_gather(e.sum(1))
        # the main path: n_calls sharded calls, this rank's launches
        dist.barrier()
        ColpairDirect.launches.clear()
        call_ms, (f, e_lj, e_c) = host_ms(
            lambda: sh(rows_b, wl_b, nw_b, box, couple))
        launches = ColpairDirect.launches.get(kern.name, 0)
        dist.barrier()
        in_ms, _ = host_ms(lambda: sh.local_inputs(rows_b, wl_b))
        red_ms, _ = host_ms(lambda: sh.reduce(f_i, f_j, e.sum(0)))
        f_all = sh.comm.all_gather(f)
        nbytes = (rows_b.numel() + pT.numel() + wl_loc.numel() + nw_b.numel()
                  + 3 + 64 + f_i.numel() + f_j.numel() + e.numel()) * 4
        out[we] = dict(
            name=kern.name, pairs=stats["pairs"], err=err,
            f_max=float(f_p.abs().max()), e_kernel=e_k, e_plain=e_p,
            rel_f=rel_f, rel_e=rel_e, ms=ms, plain_ms=plain_ms,
            call_ms=call_ms, exchange_in_ms=in_ms, reduce_ms=red_ms,
            launches=launches, calls=n_calls, nbytes=nbytes,
            s_local=sh.s_local, e_lj=float(e_lj), e_c=float(e_c),
            e_cluster=e_cluster.cpu(), f=f_all.cpu() if rank == 0 else None,
            backend=sh.comm.backend, world=sh.comm.size)
    return out


def shard_phase(asys, d, n_calls, torch, np):
    """Phase 16: the sharded colpair on config 3 over N_SHARD ranks on the
    one card (gloo). Returns (kernel entries, summary)."""
    from molchanica_tpu_torch.ops.colpair import (ColpairDirect,
                                                  colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain)
    from molchanica_tpu_torch.parallel.dryrun import sorted_colpair_state
    from molchanica_tpu_torch.parallel.launch import run_ranks
    from molchanica_tpu_torch.parallel.spatial_colpair import halo_depth_for

    top = asys.topology
    t0 = time.perf_counter()
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        np.asarray(d["x"], np.float64),
        (top.charges * top.atom_mask).numpy().astype(np.float64),
        top.lj_sigma.numpy().astype(np.float64),
        top.lj_eps.numpy().astype(np.float64),
        np.asarray(asys.box_extent, np.float64), 9.0, N_SHARD,
        device="cuda")
    halo = halo_depth_for(plan, N_SHARD, wl.cpu(), nw.cpu())
    B = plan.n_sorted // N_SHARD
    say(f"[shard] {top.n_atoms} sites per-site sorted, rc 9 A, skin 0.5: "
        f"S={plan.n_sorted} NC={plan.n_clusters} cols={plan.nx}x{plan.ny} "
        f"w_max={plan.w_max} max entries {int(nw.max())}; {N_SHARD} blocks "
        f"of {B} slots, halo depth {halo} (local j array "
        f"{(2 * halo + 1) * B} slots); built in "
        f"{time.perf_counter() - t0:.1f} s")
    refs = {}
    pT = rows.T.contiguous()
    for we in (True, False):
        one = ColpairDirect(plan, we, range_tables=True)
        f1, e1 = colpair_cuda(one.cfg, rows, pT, wl, nw, boxt,
                              one.params(rows.device))
        stats = {}
        f_p, elj_p, ec_p = colpair_plain(rows, pT, wl, nw, boxt, one.cfg,
                                         stats=stats)
        torch.cuda.synchronize()
        rel_f, rel_e = colpair_parity(f1, e1.sum(1), f_p, stats)
        err = float((f1 - f_p).abs().max()) / float(f_p.abs().max())
        ms = cuda_ms(lambda: colpair_cuda(one.cfg, rows, pT, wl, nw, boxt,
                                          one.params(rows.device)), 20)
        say(f"[shard] one device {one.name}: vs plain max|dF|/max|F|="
            f"{err:.3e}, per site {rel_f:.3e}, per cluster {rel_e:.3e}; "
            f"kernel {ms:.4f} ms on all {plan.n_clusters} clusters "
            f"({stats['pairs']} pairs)")
        if not (err < KERNEL_TOL_F_MAX and rel_f < KERNEL_TOL_F
                and rel_e < KERNEL_TOL_E):
            raise SystemExit(f"{one.name}: kernel and plain disagree")
        refs[we] = (f1.cpu(), e1.cpu(), {k: (v.cpu() if torch.is_tensor(v)
                                             else v)
                                         for k, v in stats.items()})
    t0 = time.perf_counter()
    res = run_ranks(shard_rank, N_SHARD, "gloo", "cuda",
                    (plan, halo, rows.cpu(), wl.cpu(), nw.cpu(), boxt.cpu(),
                     n_calls))
    wall = time.perf_counter() - t0
    r0 = res[0][True]
    say(f"[shard] {r0['world']} ranks over {r0['backend']} on "
        f"{sorted({r['device'] for r in res})}: spawn, checks and "
        f"{2 * n_calls} sharded calls per rank in {wall:.1f} s")
    entries, summary = [], {}
    for we in (True, False):
        rk = [r[we] for r in res]
        name = rk[0]["name"]
        for r, x in zip(res, rk):
            rel_tot = abs(x["e_kernel"] - x["e_plain"]) / max(
                abs(x["e_plain"]), 1e-30)
            say(f"[shard] rank {r['rank']} {name}: pairs={x['pairs']} "
                f"max|dF|/max|F|={x['err'] / x['f_max']:.3e} per site "
                f"{x['rel_f']:.3e} per cluster {x['rel_e']:.3e} rel_e "
                f"{rel_tot:.3e}; kernel {x['ms']:.4f} ms, plain "
                f"{x['plain_ms']:.3f} ms; sharded call {x['call_ms']:.3f} "
                f"ms (exchange in {x['exchange_in_ms']:.3f}, reduce "
                f"{x['reduce_ms']:.3f}); launches {x['launches']} of "
                f"{x['calls']} calls")
            if not (x["err"] / x["f_max"] < KERNEL_TOL_F_MAX
                    and x["rel_f"] < KERNEL_TOL_F
                    and x["rel_e"] < KERNEL_TOL_E
                    and (not we or rel_tot < KERNEL_TOL_E_TOT)):
                raise SystemExit(f"{name} rank {r['rank']}: kernel and "
                                 "plain disagree")
            if x["launches"] != x["calls"]:
                raise SystemExit(f"{name} rank {r['rank']}: {x['launches']}"
                                 f" launches in {x['calls']} calls")
        f1, e1, stats = refs[we]
        f_sh = rk[0]["f"]
        err = float((f_sh - f1).abs().max()) / float(f1.abs().max())
        rel_f, rel_e = colpair_parity(f_sh, rk[0]["e_cluster"], f1,
                                      dict(stats, e_cluster=e1.sum(1)))
        de = [abs(rk[0][k] - float(e1[:, i].sum())) / max(
            abs(float(e1[:, i].sum())), 1.0)
            for i, k in enumerate(("e_lj", "e_c"))]
        say(f"[shard] {name} assembled over {N_SHARD} ranks vs one device: "
            f"max|dF|/max|F|={err:.3e} (limit {SHARD_TOL_F_MAX:g}), per "
            f"site {rel_f:.3e}, per cluster {rel_e:.3e}; e_lj "
            f"{rk[0]['e_lj']:.4f} vs {float(e1[:, 0].sum()):.4f}, e_c "
            f"{rk[0]['e_c']:.4f} vs {float(e1[:, 1].sum()):.4f} (rel "
            f"{max(de):.3e})")
        if not (err < SHARD_TOL_F_MAX and rel_f < KERNEL_TOL_F
                and rel_e < KERNEL_TOL_E and max(de) < KERNEL_TOL_E_TOT):
            raise SystemExit(f"{name}: sharded and one device disagree")
        mean = lambda k: float(np.mean([x[k] for x in rk]))
        # the bound of the mean rank's work, as ms is the mean rank's time
        t_ops = mean("pairs") * PAIR_OPS[("full", we)] / PEAK_FP32 * 1e3
        t_bytes = mean("nbytes") / PEAK_BYTES * 1e3
        entries.append(dict(
            name=name, route="cuda",
            source="molchanica_tpu_torch/csrc/colpair.cu",
            replaces="molchanica_tpu/ops/pallas/colpair.py:810",
            launches=sum(x["launches"] for x in rk),
            max_abs_err=max(x["err"] for x in rk), ms=mean("ms"),
            plain_ms=mean("plain_ms"),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=None, ranks=N_SHARD, halo=halo,
            per_rank=[{k: x[k] for k in ("pairs", "ms", "plain_ms",
                                         "call_ms", "exchange_in_ms",
                                         "reduce_ms", "launches", "rel_f",
                                         "rel_e")} for x in rk],
            assembled_rel_err=err))
        summary[name] = dict(call_ms=mean("call_ms"),
                             exchange_in_ms=mean("exchange_in_ms"),
                             reduce_ms=mean("reduce_ms"), kernel_ms=mean("ms"))
        say(f"[time] {name}: kernel {mean('ms'):.4f} ms per rank (mean of "
            f"{N_SHARD}, each alone on the card), plain "
            f"{mean('plain_ms'):.3f} ms, bound {entries[-1]['bound_ms']:.5f}"
            f" ms ({entries[-1]['bound_by']}); sharded call "
            f"{mean('call_ms'):.3f} ms, exchange in "
            f"{mean('exchange_in_ms'):.3f} ms, reduce "
            f"{mean('reduce_ms'):.3f} ms")
    return entries, dict(summary, halo=halo, S=plan.n_sorted, ranks=N_SHARD,
                         backend=r0["backend"], wall_s=wall)


def nvt_hold(sim, n, np):
    """Mean temperature over n more steps, sampled every 200."""
    temps = []
    for _ in range(n // 200):
        sim.step(0.002, 200)
        temps.append(sim.temperature())
    mean = float(np.mean(temps))
    say(f"[hold] {n} steps: T mean {mean:.2f} K, min {min(temps):.2f}, "
        f"max {max(temps):.2f} (target 310 K)")
    if not abs(mean - 310.0) < 5.0:
        raise SystemExit(f"NVT hold off target: {mean} K")


def profile_steps(sim, n, torch, out_dir, prefix=""):
    """Trace n steps: device busy share, kernel launches per step and the
    kernels by device time (full tables in out_dir/profile.txt if given)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.step(0.002, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(ka[0], "self_device_time_total")
           else "self_cuda_time_total")
    # device-side events only (the aten ops that launched them carry the
    # same time again)
    dev = [(getattr(e, key), e) for e in ka
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(t for t, _ in dev) / 1e3
    launches = sum(e.count for _, e in dev)
    say(f"[{prefix}profile] {n} steps: wall {wall_ms / n:.3f} ms/step, "
        f"device busy {dev_ms / n:.3f} ms/step "
        f"({100.0 * dev_ms / wall_ms:.1f}%), "
        f"{launches / n:.0f} kernels/step")
    for t, e in sorted(dev, key=lambda p: -p[0])[:15]:
        say(f"[{prefix}profile] {t / 1e3 / n:9.4f} ms/step "
            f"{e.count / n:7.1f}/step {e.key[:90]}")
    if out_dir:
        with open(os.path.join(out_dir, f"{prefix}profile.txt"), "w") as fh:
            fh.write(ka.table(sort_by=key, row_limit=80))
            fh.write("\n\n")
            fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=80))


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=N_TIMED,
                    help="timed steps (default %(default)s)")
    ap.add_argument("--warm", type=int, default=N_WARM,
                    help="warm-up steps (default %(default)s)")
    ap.add_argument("--hold", type=int, default=0, metavar="N",
                    help="after the timed run, hold N more steps and check "
                    "their mean temperature (off by default)")
    ap.add_argument("--md-steps", type=int, default=N_MD_TIMED,
                    help="timed MdSim steps (default %(default)s)")
    ap.add_argument("--md-warm", type=int, default=N_MD_WARM,
                    help="MdSim warm-up steps (default %(default)s)")
    ap.add_argument("--ti-equil", type=int, default=N_TI_EQUIL,
                    help="equilibration steps per lambda window "
                    "(default %(default)s)")
    ap.add_argument("--ti-prod", type=int, default=N_TI_PROD,
                    help="production steps per lambda window "
                    "(default %(default)s)")
    ap.add_argument("--range-steps", type=int, default=N_RANGE_STEPS,
                    help="timed FastSim(per_slice_k=0) steps "
                    "(default %(default)s)")
    ap.add_argument("--range-warm", type=int, default=N_RANGE_WARM,
                    help="its warm-up steps (default %(default)s)")
    ap.add_argument("--shard-calls", type=int, default=N_SHARD_CALLS,
                    help="sharded colpair calls per variant and rank "
                    "(default %(default)s)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, trace N more FastSim steps "
                    "with torch.profiler")
    ap.add_argument("--md-profile", type=int, default=0, metavar="N",
                    help="after the checks, trace N more MdSim steps")
    ap.add_argument("--out", metavar="DIR",
                    help="write chip_smoke.json (and profile.txt) here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    if not os.path.isdir(os.path.join(ROOT, "molchanica_tpu_torch")):
        raise SystemExit("chip_smoke: run it from a checkout of the "
                         "repository (molchanica_tpu_torch/ not found)")
    sys.path.insert(0, ROOT)
    import numpy as np

    # ---- 1. the card ----
    card = card_line()
    say(f"[card] {card}")
    say(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 2. build ----
    from molchanica_tpu_torch import cuda_build
    t0 = time.perf_counter()
    cuda_build.build()
    say(f"[build] colpair.cu + direct_force.cu built in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            say(f"[build] {line.strip()}")

    # ---- 3. the system ----
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)
    from molchanica_tpu_torch.md.fast_engine import FastSim
    from molchanica_tpu_torch.ops.colpair import ColpairDirect
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    t0 = time.perf_counter()
    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    d = np.load(FIXTURE)
    if d["x"].shape != asys.positions.shape or not np.allclose(
            d["box"], np.asarray(asys.box_extent)):
        raise SystemExit("eq25k.npz does not match the built system")
    cfg = MdConfig(
        integrator=Integrator.langevin_middle(gamma=1.0), temp_target=310.0,
        lj_cutoff=9.0, coulomb_cutoff=9.0,
        hydrogen_constraint=HydrogenConstraint.shake(), dtype="float32",
        max_init_relaxation_iters=None, neighbor_rebuild_every=20, seed=7)
    say(f"[system] built {asys.topology.n_atoms_real} sites in "
        f"{time.perf_counter() - t0:.1f} s")

    def build(device):
        return FastSim(asys.topology, cfg, d["x"],
                       box_extent=asys.box_extent, velocities=d["v"],
                       device=device)

    t0 = time.perf_counter()
    sim = build("cuda")
    torch.cuda.synchronize()
    sp = sim._split
    say(f"[system] FastSim init {time.perf_counter() - t0:.1f} s: S={sim.S} "
        f"S_L={sp['S_L']} S_Q={sp['S_Q']} cols={sim.plan.nx}x{sim.plan.ny} "
        f"pme={tuple(sim._recip.K)} box={float(asys.box_extent[0]):.4f} "
        f"tf32={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 4. kernel parity ----
    entries = kernel_parity(sim, torch)

    # ---- 5. the main path ----
    ColpairDirect.launches.clear()
    evals0 = sim.force_evals
    dt = 0.002
    t0 = time.perf_counter()
    sim.step(dt, args.warm)
    torch.cuda.synchronize()
    say(f"[run] warm-up {args.warm} steps in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sim.step(dt, args.steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    e_pot = sim.potential_energy()
    torch.cuda.synchronize()
    counts = dict(ColpairDirect.launches)
    ms_step = elapsed / args.steps * 1e3
    ns_day = args.steps * dt / 1000.0 / elapsed * 86400.0
    t_final = sim.temperature()
    x = sim.positions_unsorted()
    finite = bool(np.isfinite(x).all())
    n_eval = sim.force_evals - evals0      # one per step, plus replans
    expected = 2 * n_eval
    total = sum(counts.values())
    say(f"[run] n={args.steps} ms/step={ms_step:.4f} ns/day={ns_day:.3f} "
        f"T={t_final:.2f} K E_pot={e_pot:.3f} kcal/mol finite={finite} "
        f"overflow={int(sim.state.overflow)} psk={sim._psk}")
    say(f"[run] colpair launches {total} (expected 2 x {n_eval} force "
        f"evaluations = {expected}): {counts}")
    for e in entries:
        e["launches"] = counts.get(e["name"], 0)
    if not finite or not 100.0 < t_final < 600.0:
        raise SystemExit(f"unstable run: finite={finite} T={t_final}")
    if not np.isfinite(e_pot):
        raise SystemExit("non-finite potential energy")
    if total != expected or any(e["launches"] == 0 for e in entries):
        raise SystemExit(f"kernel launches {counts} != {expected}")

    if args.hold:
        nvt_hold(sim, args.hold, np)

    # ---- 6. engine parity ----
    engine_parity(build, torch)

    # ---- 7. MdSim on the same system ----
    from molchanica_tpu_torch.md.engine import MdSim
    md_cfg = cfg.replace(use_pallas=True)

    def build_md(device):
        return MdSim(asys.topology, md_cfg, d["x"],
                     box_extent=asys.box_extent, velocities=d["v"],
                     method="cells_pme", relax=False, device=device)

    t0 = time.perf_counter()
    md = build_md("cuda")
    torch.cuda.synchronize()
    plan = md._plan
    sa = md._rebuild(md.state.positions, md.state.box)[0]
    occ = int((sa.view(plan.n_cells, plan.capacity) >= 0).sum(1).max())
    say(f"[md] MdSim init {time.perf_counter() - t0:.2f} s: nc={plan.nc} "
        f"C={plan.capacity} n_cells={plan.n_cells} max occupancy={occ} "
        f"side={plan.cell_side[0]:.4f} pme={md._recip.grid} "
        f"constraints={md.n_constraints}")

    # ---- 8. K2 parity ----
    k2 = k2_parity(md, torch)

    # ---- 9. the MdSim path ----
    md_res = md_path(md, [args.md_warm, args.md_steps], torch, np)
    k2["launches"] = md_res["launches"]
    entries.append(k2)

    # ---- 10. MdSim engine parity ----
    md_engine_parity(build_md, torch)

    # ---- 11. the hydration system ----
    asys_h, cfg_h, sim_h = hydration_system(torch, np)

    # ---- 12. K1d parity ----
    alch_entries = kernel_parity(sim_h, torch, couples=ALCH_COUPLES)

    # ---- 13. alchemical engine parity ----
    t0 = time.perf_counter()
    e_min = sim_h.minimize(cfg_h.neighbor_rebuild_every)
    torch.cuda.synchronize()
    say(f"[alch-engine] minimize({cfg_h.neighbor_rebuild_every}) on the "
        f"card: E_pot {e_min:.3f} kcal/mol before the last move, "
        f"{time.perf_counter() - t0:.1f} s")
    x_rel = sim_h.positions_unsorted()
    v_zero = np.zeros_like(x_rel)

    def build_h(device):
        return FastSim(asys_h.topology, cfg_h, x_rel,
                       box_extent=asys_h.box_extent, velocities=v_zero,
                       device=device)

    engine_parity(build_h, torch, lam=1.0 - ALCH_COUPLES[0],
                  tag="alch-engine")
    del sim_h

    # ---- 14. the TI path ----
    ti, ti_counts = ti_path(args.ti_equil, args.ti_prod, torch, np)
    for e in alch_entries:
        e["launches"] = ti_counts.get(e["name"], 0)
    if any(e["launches"] == 0 for e in alch_entries):
        raise SystemExit(f"TI path: a K1d instance never launched: "
                         f"{ti_counts}")
    entries[4:4] = alch_entries

    # ---- 15. K1c: FastSim on range tables ----
    range_entries, range_res = range_path(
        lambda: FastSim(asys.topology, cfg, d["x"],
                        box_extent=asys.box_extent, velocities=d["v"],
                        per_slice_k=0, device="cuda"),
        args.range_warm, args.range_steps, torch, np)
    entries[8:8] = range_entries

    # ---- 16. K1f: the sharded colpair over ranks on the card ----
    shard_entries, shard_res = shard_phase(asys, d, args.shard_calls, torch,
                                           np)
    entries[12:12] = shard_entries

    # ---- 17. the spatial dry run on the card ----
    from molchanica_tpu_torch.parallel.dryrun import dryrun_multidevice
    t0 = time.perf_counter()
    dry = dryrun_multidevice(4, "gloo", "cuda")
    say(f"[dryrun] {time.perf_counter() - t0:.1f} s, ranks on "
        f"{torch.cuda.get_device_name(0)}")

    # ---- 18. results ----
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        profile_steps(sim, args.profile, torch, args.out)
    if args.md_profile:
        profile_steps(md, args.md_profile, torch, args.out, "md_")
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, ms_per_step=ms_step,
                           ns_per_day=ns_day, temperature_K=t_final,
                           elapsed_s=elapsed, n_timed=args.steps,
                           md=md_res, ti=ti, range=range_res,
                           shard=shard_res, dryrun=dry, kernels=entries), fh,
                      indent=1)
    say(json.dumps({"kernels": [
        {k: e[k] for k in ("name", "route", "source", "replaces",
                           "launches", "max_abs_err", "ms", "plain_ms",
                           "bound_ms", "bound_by", "library_ms")}
        for e in entries]}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
