#!/usr/bin/env python3
"""Device times of the cell-grid kernel K2 (csrc/direct_force.cu) and the
probe P (csrc/probe_prefetch.cu) of one tree of the port, on one CUDA card.

    python3 scripts/k2_probe_times.py [--root DIR] [--out FILE] [--phases]
        [--k2-out FILE] [--k2-same FILE]

`--root` names the checkout whose molchanica_tpu_torch is built and timed
(default: this one), so that two builds of the kernels can be compared in
one call: unpack another commit with `git archive` into _checkout/
(gitignored) and time both trees, in turns. K2 runs on config 3's cell grid
(the committed eq25k.npz state, 6 x 6 x 6 cells of capacity 256), P at the
probe script's shapes (16 clusters x 8 entries, S = 1,024) and at 416 x 8,
S = 26,624. Each kernel is first held against its plain torch version on
the same inputs (K2 per slot and per cell at 1e-5 of the pair-term
magnitudes, P at rel 1e-6), then timed by graph_ms (launches replayed from
one CUDA graph: the device's time) and cuda_ms (eager calls, the host's
cost per call included). K2 takes couple and beta as scalars on the card; a tree
with the old C entry (13 arguments, whose wrapper copied beta from the
host and so could not be captured) is launched through that entry with a
params tensor made once, so that both are timed alike. Prints one JSON line, and
writes it to FILE with `--out`. `--k2-out FILE` saves K2's output on
config 3's grid (torch.save), and `--k2-same FILE` holds this tree's
output to such a file bit for bit (two trees' K2 on the same inputs:
run the other tree with --k2-out first).

`--phases` (this checkout's kernel only) also builds variants of
csrc/direct_force.cu made by text substitution (cuda_build.build_variants:
each must match exactly once) and times each, launched through the
wrapper, on the same inputs by graph_ms:

  full     the kernel as committed;
  test     staging and the pair test with its queue, but no batch (no pair
           math, no reductions);
  staging  the cell's sites ranked, the box, the neighbourhood scanned and
           compacted, but no chunk;
  fixed    every block exits after ranking its cell's sites (start-up,
           the empty rows, the energy kernel, the wrapper's allocations);
  part64   parts of up to 64 sites (half the blocks, twice the sites each);
  regs85   launch bounds of 3 blocks per SM (up to 85 registers).

Differences read as: staging = staging - fixed, pair test = test -
staging, pair math and reductions = full - test. Only `full` and the
tuning variants give right outputs, and those are checked.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_GRAPH = 50
PHASES = {
    "full": [],
    "test": [("for (int b = 0; b < cnt; b += 32) {",
              "for (int b = 0; b < 0; b += 32) {")],
    "staging": [("for (int ch = wp; ch < n_ch; ch += NWARP) {",
                 "for (int ch = wp; ch < 0; ch += NWARP) {")],
    "fixed": [("if (part >= n_part) {", "if (true) {")],
    "part64": [("constexpr int PART_I = 32;", "constexpr int PART_I = 64;")],
    "regs85": [("__launch_bounds__(THREADS, 4)",
                "__launch_bounds__(THREADS, 3)")],
}


def _smoke():
    """chip_smoke.py of this checkout, for its timers."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def k2_inputs(torch, np):
    """(plan, direct, center, ghost, kw) of config 3's cell grid at
    eq25k.npz; kw holds the K2 calls' exclusion table on the card where the
    tree has one (a tree before it adds every pair)."""
    from molchanica_tpu_torch.md.energy import apply_virtual_sites
    from molchanica_tpu_torch.ops.direct_force import (DirectForce,
                                                       image_shift,
                                                       make_rebuild_fn,
                                                       plan_window)
    from molchanica_tpu_torch.systems.bench_systems import \
        build_solvated_protein

    asys = build_solvated_protein(n_residues=250, target_sites=25000, seed=3)
    d = np.load(os.path.join(HERE, "molchanica_tpu", "systems", "data",
                             "eq25k.npz"))
    x = torch.as_tensor(d["x"], dtype=torch.float32)
    box = torch.as_tensor(np.asarray(asys.box_extent), dtype=torch.float32)
    xv = apply_virtual_sites(x, asys.topology)
    plan = plan_window(np.asarray(asys.box_extent), 9.0,
                       asys.topology.n_atoms_real, asys.topology.n_atoms,
                       x0=xv.numpy())
    sa, _, ovf = make_rebuild_fn(plan, asys.topology.atom_mask)(xv, box)
    try:
        from molchanica_tpu_torch.ops.exclusions import exclusion_table
    except ImportError:
        direct, kw = DirectForce(asys.topology, plan), {}
    else:
        direct = DirectForce(asys.topology, plan,
                             exclusion_table(asys.topology))
        kw = {"excl": direct.excl.to("cuda")}
    center, ghost = direct.inputs(xv, box, sa, image_shift(xv, box))
    assert int(ovf) == 0
    return plan, direct, center.cuda(), ghost.cuda(), kw


def k2_launcher(plan, center, ghost, couple, beta, kw, torch):
    """fn() launching the tree's K2 once on the current stream; the old C
    entry (13 arguments) takes no scratch and no counter."""
    from molchanica_tpu_torch.cuda_build import load_library
    from molchanica_tpu_torch.ops import direct_force as DF

    lib = load_library()
    dev = center.device
    if len(lib.direct_force_launch.argtypes) != 13:
        return lambda: DF.direct_force_cuda(plan, center, ghost, couple, beta,
                                            **kw)
    params = torch.stack([couple.reshape(()).float(),
                          beta.reshape(()).float()])
    gx, gy, gz = plan.ghost_dims
    G = gx * gy * gz * plan.capacity
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def launch():
        out = torch.empty((center.shape[0], 4), dtype=torch.float32,
                          device=dev)
        err = lib.direct_force_launch(
            plan.n_cells, plan.capacity, plan.nc[1], plan.nc[2], gy, gz, G,
            ctypes.c_float(float(plan.cutoff) ** 2), ptr(center), ptr(ghost),
            ptr(params), ptr(out),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        if err != 0:
            raise RuntimeError(f"direct_force launch failed: {err}")
        return out
    return launch


def phase_times(plan, center, ghost, couple, beta, kw, ref, stats, smoke,
                torch):
    """{variant: graph ms} of PHASES on one input, with ptxas's registers
    and spills per variant; the right variants checked against `ref`."""
    import tempfile

    from molchanica_tpu_torch import cuda_build
    from molchanica_tpu_torch.ops import direct_force as DF

    launch = lambda: DF.direct_force_cuda(plan, center, ghost, couple, beta,
                                          **kw)
    out, regs = {}, {}
    load_library = cuda_build.load_library
    with tempfile.TemporaryDirectory() as tmp:
        libs = cuda_build.build_variants("direct_force.cu", PHASES, tmp)
        try:
            for name, (lib, report) in libs.items():
                regs[name] = report
                cuda_build.load_library = lambda lib=lib: lib
                o = launch()
                if name in ("full", "part64", "regs85"):
                    e_k = DF.cell_energies(o, plan.n_cells)
                    rel = DF.direct_force_parity(o[:, :3], e_k.sum(1),
                                                 ref[:, :3], stats)
                    if not max(rel) < 1e-5:
                        raise SystemExit(f"variant {name} disagrees: {rel}")
                out[name] = smoke.graph_ms(launch, N_GRAPH)
        finally:
            cuda_build.load_library = load_library
    return out, regs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--out")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--k2-out")
    ap.add_argument("--k2-same")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_probe_times: no CUDA device")
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "molchanica_tpu_torch")):
        raise SystemExit(f"k2_probe_times: no molchanica_tpu_torch in {root}")
    smoke = _smoke()
    sys.path.insert(0, root)
    from molchanica_tpu_torch import cuda_build
    from molchanica_tpu_torch.ops import direct_force as DF
    from molchanica_tpu_torch.ops import probe_prefetch as P

    card = smoke.card_line()
    cuda_build.build()
    regs = [ln.strip() for ln in cuda_build.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    res = dict(root=os.path.relpath(root, HERE), card=card, ptxas=regs)

    plan, direct, center, ghost, kw = k2_inputs(torch, np)
    couple = torch.ones((), dtype=torch.float32, device="cuda")
    beta = torch.tensor(0.3123, device="cuda")
    launch = k2_launcher(plan, center, ghost, couple, beta, kw, torch)
    out = launch()
    stats = {}
    ref = DF.direct_force_plain(center, ghost, direct.starts.cuda(), couple,
                                beta, direct.rc2, stats=stats, **kw)
    torch.cuda.synchronize()
    e_k = DF.cell_energies(out, plan.n_cells)
    rel_f, rel_e = DF.direct_force_parity(out[:, :3], e_k.sum(1), ref[:, :3],
                                          stats)
    if not (rel_f < 1e-5 and rel_e < 1e-5):
        raise SystemExit(f"K2 disagrees with its plain version: {rel_f} "
                         f"{rel_e}")
    res["k2"] = dict(graph_ms=smoke.graph_ms(launch, N_GRAPH),
                     cuda_ms=smoke.cuda_ms(launch, N_GRAPH),
                     pairs=stats["pairs"], site_rel_err=rel_f,
                     cell_rel_err_e=rel_e)
    if args.k2_out:
        torch.save(out.cpu(), args.k2_out)
    if args.k2_same:
        same = torch.equal(out.cpu(), torch.load(args.k2_same))
        res["k2"]["same_bits_as"] = {args.k2_same: same}
        if not same:
            raise SystemExit(f"K2's output differs from {args.k2_same}")
    if args.phases:
        if root != HERE:
            raise SystemExit("--phases times this checkout's kernel only")
        ms, regs = phase_times(plan, center, ghost, couple, beta, kw, ref,
                               stats, smoke, torch)
        res["k2_phases"] = dict(ms=ms, ptxas=regs)
        print("[phases] " + ", ".join(f"{k} {v:.5f} ms"
                                        for k, v in ms.items())
              + f"; staging {ms['staging'] - ms['fixed']:.5f}, pair test "
              f"{ms['test'] - ms['staging']:.5f}, pair math and reductions "
              f"{ms['full'] - ms['test']:.5f} ms", flush=True)

    for tag, (NC, W, S) in (("probe", (16, 8, None)),
                            ("probe_big", smoke.PROBE_BIG)):
        arrs = P.probe_inputs(NC, W, S)
        nw, sl, rows, pT = (torch.as_tensor(a, device="cuda") for a in arrs)
        fn = lambda: P.probe_cuda(nw, sl, rows, pT)
        o, o2 = fn()
        op, o2p = P.probe_plain(nw, sl, rows, pT)
        torch.cuda.synchronize()
        err = max(P.rel_errors(o.cpu().numpy(), o2.cpu().numpy(),
                               op.cpu().numpy(), o2p.cpu().numpy()))
        if err >= 1e-6:
            raise SystemExit(f"{tag} disagrees with its plain version: {err}")
        res[tag] = dict(graph_ms=smoke.graph_ms(fn, N_GRAPH),
                        cuda_ms=smoke.cuda_ms(fn, N_GRAPH), rel_err=err)
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
