#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (molchanica_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed on lines of its own:
  1. the card (nvidia-smi name and power limit) and torch's CUDA version;
  2. build of the hand-written kernels from csrc/ (nvcc, sm_90a);
  3. the ~25k-site solvated polyalanine (config 3 of BASELINE.md) from the
     port's own builder, started from the committed eq25k.npz fixture, in
     FastSim with the benchmark's MdConfig;
  4. kernel parity: on the real L and Q subset tables after the first
     rebuild, every colpair instance the path runs (L/Q x force-only/
     energy) against its plain torch version on the same inputs;
  5. the main path: a sim.step() warm-up and one timed call, then
     sim.potential_energy(); kernel launch counts over exactly that run;
  6. engine parity: the whole force of a fresh engine on the card against
     the same engine on the CPU (plain kernel twin), on the same state,
     through both force functions the path runs: force-only (the K-poly
     kernels of every step) and with energies (its terms too);
  7. the kernel JSON line, the card line, and the final JSON result line.
An NVT hold (the mean temperature of further steps near 310 K) runs only
when --hold N asks for it.

Kernel parity is held to two gates. The whole-array one: max|dF|/max|F|
< 1e-4 and total energies rel < 1e-5. And one scaled per site: a force
error against the sum, over that site's pairs, of the magnitudes of the
terms each pair force is made of, an energy error against the same sum
over its i-cluster's pair energies (colpair_parity). Excluded solute pairs
enter the kernel at ~1e5 kcal/mol/A at the C1 sigma clamp and are
subtracted again, so the whole-array ratio alone would let an error of a
whole site force through everywhere else.

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
N_TIMED = 1000
N_WARM = 200
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


def kernel_parity(sim, torch):
    """Each colpair instance of the path vs colpair_plain on the state's
    tables. Returns one JSON kernel entry per instance."""
    from molchanica_tpu_torch.ops.colpair import (ICL, colpair_cuda,
                                                  colpair_parity,
                                                  colpair_plain)

    st = sim.state
    sp = st.split
    x_ext = torch.cat([st.x, torch.full((1, 3), 1.0e6, device=st.x.device)])
    entries = []
    for key in ("l", "q"):
        rows = torch.cat([x_ext[sp[f"idx_{key}"]], sp[f"props_{key}"]], 1)
        pT = rows.T.contiguous()
        wl, nw = sp[f"wl_{key}"], sp[f"nw_{key}"]
        S = rows.shape[0]
        for we in (False, True):
            kern = sim._split["kernels"][we][key.upper()]
            f_k, e_k = colpair_cuda(kern.cfg, rows, pT, wl, nw, st.box,
                                    kern.params(rows.device))
            stats = {}
            f_p, elj_p, ec_p = colpair_plain(rows, pT, wl, nw, st.box,
                                             kern.cfg, stats=stats)
            torch.cuda.synchronize()
            rel_f, rel_e = colpair_parity(f_k, e_k.sum(1), f_p, stats)
            err = float((f_k - f_p).abs().max())
            f_max = float(f_p.abs().max())
            e_kern = float(e_k.sum())
            e_plain = float(elj_p + ec_p)
            rel_tot = abs(e_kern - e_plain) / max(abs(e_plain), 1e-30)
            say(f"[parity] {kern.name} S={S} NC={S // ICL} "
                f"max_entries={int(nw.max())} pairs={stats['pairs']} "
                f"max|dF|/max|F|={err / f_max:.3e} (max|dF|={err:.4e}, "
                f"max|F|={f_max:.4e}) e_kernel={e_kern:.6f} "
                f"e_plain={e_plain:.6f} rel_e={rel_tot:.3e} "
                f"(limits {KERNEL_TOL_F_MAX:g}, {KERNEL_TOL_E_TOT:g})")
            say(f"[parity] {kern.name} per site max|dF|/scale={rel_f:.3e}, "
                f"per cluster |dE|/scale={rel_e:.3e} (limits "
                f"{KERNEL_TOL_F:g}, {KERNEL_TOL_E:g})")
            if not (err / f_max < KERNEL_TOL_F_MAX
                    and rel_tot < KERNEL_TOL_E_TOT
                    and rel_f < KERNEL_TOL_F and rel_e < KERNEL_TOL_E):
                raise SystemExit(f"{kern.name}: kernel and plain disagree")
            ms = cuda_ms(lambda: kern(rows, pT, wl, nw, st.box, st.couple),
                         50)
            plain_ms = cuda_ms(lambda: colpair_plain(
                rows, pT, wl, nw, st.box, kern.cfg), 3)
            ops = stats["pairs"] * PAIR_OPS[(kern.cfg.mode, we)]
            nbytes = (rows.numel() + pT.numel() + wl.numel() + nw.numel()
                      + 3 + 64) * 4 + (S * 3 + (S // ICL) * 2) * 4
            t_ops = ops / PEAK_FP32 * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            entries.append(dict(
                name=kern.name, route="cuda",
                source="molchanica_tpu_torch/csrc/colpair.cu",
                replaces="molchanica_tpu/ops/pallas/colpair.py:810",
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None, pairs=stats["pairs"], S=S,
                site_rel_err=rel_f, cluster_rel_err_e=rel_e))
            say(f"[time] {kern.name}: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.3f} ms, bound {max(t_ops, t_bytes):.5f} ms "
                f"({entries[-1]['bound_by']})")
    return entries


def engine_parity(build, torch):
    """The card's force against the CPU engine's on the same state, for the
    force-only function (the K-poly kernels of every step) and the one with
    energies (whose terms must agree to rel 1e-5 too). Per site the limit
    is ENGINE_TOL_F of max|F| plus ENGINE_TOL_DIRECT of the site's
    direct-space scale (the plain kernels' f_abs, owned and spread like the
    force): excluded solute pairs enter the kernel at ~1e5 kcal/mol/A and
    are subtracted again, which leaves a float32 floor at those sites only
    (see tests/test_torch_fast_engine.py)."""
    from molchanica_tpu_torch.ops.colpair import colpair_plain

    t0 = time.perf_counter()
    sim = build("cuda")
    cpu = build("cpu")
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
                          stats=stats)
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
                ("lj", "coulomb") if we else ())
            worst_e = max(abs(float(tg[k]) - float(tc[k]))
                          / abs(float(tc[k])) for k in terms)
            say(f"[engine] {'energy' if we else 'force-only'}: card vs CPU "
                f"on the init state: max|dF|={float(err.max()):.4f} "
                f"(max|F|={f_max:.2f}); worst site {worst}: |dF|="
                f"{float(err[worst]):.4f} against limit "
                f"{float(tol[worst]):.4f} (direct scale "
                f"{float(a[worst]):.4e}); worst energy term rel "
                f"{worst_e:.2e}")
            if not (bool((err <= tol).all()) and worst_e < 1e-5):
                raise SystemExit("engine parity failed")
    say(f"[engine] CPU engine and checks {time.perf_counter() - t0:.1f} s")


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


def profile_steps(sim, n, torch, out_dir):
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
    say(f"[profile] {n} steps: wall {wall_ms / n:.3f} ms/step, device busy "
        f"{dev_ms / n:.3f} ms/step ({100.0 * dev_ms / wall_ms:.1f}%), "
        f"{launches / n:.0f} kernels/step")
    for t, e in sorted(dev, key=lambda p: -p[0])[:15]:
        say(f"[profile] {t / 1e3 / n:9.4f} ms/step {e.count / n:7.1f}/step "
            f"{e.key[:90]}")
    if out_dir:
        with open(os.path.join(out_dir, "profile.txt"), "w") as fh:
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
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after the checks, trace N more steps with "
                    "torch.profiler")
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
    say(f"[build] colpair built in {time.perf_counter() - t0:.1f} s")
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

    # ---- 7. results ----
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        profile_steps(sim, args.profile, torch, args.out)
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(dict(card=card, torch=torch.__version__,
                           cuda=torch.version.cuda, ms_per_step=ms_step,
                           ns_per_day=ns_day, temperature_K=t_final,
                           elapsed_s=elapsed, n_timed=args.steps,
                           kernels=entries), fh, indent=1)
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
