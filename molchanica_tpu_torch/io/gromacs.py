"""GROMACS interop: export a simulation as .gro/.top/.mdp input files.

Copy of molchanica_tpu.io.gromacs: the same host code, so its texts
equal the reference's byte for byte, but for run_gromacs_md, which takes
its input paths from make_gromacs_input's directory (the JAX package's
indexes the returned .mdp path as a dict and raises).

Reference: `make_gromacs_input` (src/gromacs/mod.rs:55 — MdConfig -> mdp/gro/
top conversion, A->nm at :53, solvent mapping :101-112) and
`MdConfig::to_gromacs(num_steps, dt)` (SURVEY §2.1). This gives users a
portable run description for cross-validation against gmx mdrun.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np

NM = 10.0
KCAL_TO_KJ = 4.184
DEG = 180.0 / math.pi


def make_mdp(cfg, n_steps: int, dt_ps: float,
             output_interval: int = 1000) -> str:
    """MdConfig -> .mdp text (reference to_gromacs / MdpParams)."""
    integ = {"leapfrog": "md", "verlet_velocity": "md-vv",
             "langevin_middle": "sd"}[cfg.integrator.kind]
    lines = [
        f"integrator               = {integ}",
        f"dt                       = {dt_ps}",
        f"nsteps                   = {n_steps}",
        f"nstxout                  = {cfg.snapshot_handlers.gromacs.nstxout or output_interval}",
        f"nstvout                  = {cfg.snapshot_handlers.gromacs.nstvout or 0}",
        f"nstenergy                = {cfg.snapshot_handlers.gromacs.nstenergy or output_interval}",
        "cutoff-scheme            = Verlet",
        f"rcoulomb                 = {cfg.coulomb_cutoff / NM}",
        f"rvdw                     = {cfg.lj_cutoff / NM}",
        "coulombtype              = PME",
        f"pme-order                = {cfg.pme_order}",
    ]
    if cfg.integrator.kind == "langevin_middle":
        lines += [f"tau-t                    = {1.0 / max(cfg.integrator.gamma, 1e-3)}"]
    elif cfg.integrator.thermostat_tau is not None:
        lines += ["tcoupl                   = v-rescale",
                  f"tau-t                    = {cfg.integrator.thermostat_tau}"]
    lines += ["tc-grps                  = System",
              f"ref-t                    = {cfg.temp_target}"]
    if cfg.barostat_cfg is not None:
        lines += [
            "pcoupl                   = C-rescale",
            f"tau-p                    = {cfg.barostat_cfg.tau}",
            f"ref-p                    = {cfg.barostat_cfg.pressure_target}",
            "compressibility          = 4.5e-5",
        ]
    hc = cfg.hydrogen_constraint.kind
    if hc == "linear":
        lines += ["constraints              = h-bonds",
                  "constraint-algorithm     = lincs",
                  f"lincs-order              = {cfg.hydrogen_constraint.order}",
                  f"lincs-iter               = {cfg.hydrogen_constraint.iters}"]
    elif hc == "shake":
        lines += ["constraints              = h-bonds",
                  "constraint-algorithm     = shake",
                  f"shake-tol                = {cfg.hydrogen_constraint.shake_tolerance}"]
    if cfg.zero_com_drift:
        lines += ["comm-mode                = Linear"]
    return "\n".join(lines) + "\n"


def make_top(asys, mol_name: str = "MOL") -> str:
    """AssembledSystem -> minimal .top with inline atom types.

    Units: sigma nm, eps kJ/mol; bond k kJ/mol/nm^2 (x2 for the 1/2
    convention difference), angle k kJ/mol/rad^2 (x2).
    """
    top = asys.topology
    n = asys.n_solute_atoms
    q = np.asarray(top.charges)[:n]
    sig = np.asarray(top.lj_sigma)[:n]
    eps = np.asarray(top.lj_eps)[:n]
    mass = np.asarray(top.masses)[:n]

    types = {}
    type_of = []
    for i in range(n):
        key = (round(float(sig[i]), 4), round(float(eps[i]), 4),
               round(float(mass[i]), 3))
        if key not in types:
            types[key] = f"mt{len(types)}"
        type_of.append(types[key])

    out = ["[ defaults ]",
           "; nbfunc comb-rule gen-pairs fudgeLJ fudgeQQ",
           "1 2 yes 0.5 0.8333", "",
           "[ atomtypes ]",
           "; name at.num mass charge ptype sigma(nm) epsilon(kJ/mol)"]
    for (s, e, m), name in types.items():
        out.append(f"{name} 6 {m:.4f} 0.0 A {s / NM:.6f} {e * KCAL_TO_KJ:.6f}")
    out += ["", "[ moleculetype ]", f"{mol_name} 3", "", "[ atoms ]"]
    for i in range(n):
        out.append(f"{i + 1} {type_of[i]} 1 {mol_name} A{i + 1} {i + 1} "
                   f"{float(q[i]):.4f} {float(mass[i]):.4f}")
    bidx = np.asarray(top.bond_idx)
    bk = np.asarray(top.bond_k)
    br = np.asarray(top.bond_r0)
    out += ["", "[ bonds ]"]
    for r in range(len(bidx)):
        i, j = int(bidx[r, 0]), int(bidx[r, 1])
        if bk[r] == 0 or i >= n or j >= n:
            continue
        out.append(f"{i + 1} {j + 1} 1 {br[r] / NM:.5f} "
                   f"{2 * bk[r] * KCAL_TO_KJ * 100:.2f}")
    aidx = np.asarray(top.angle_idx)
    ak = np.asarray(top.angle_k)
    at = np.asarray(top.angle_theta0)
    out += ["", "[ angles ]"]
    for r in range(len(aidx)):
        a, b, c = (int(v) for v in aidx[r])
        if ak[r] == 0 or max(a, b, c) >= n:
            continue
        out.append(f"{a + 1} {b + 1} {c + 1} 1 {at[r] * DEG:.3f} "
                   f"{2 * ak[r] * KCAL_TO_KJ:.3f}")
    didx = np.asarray(top.dihedral_idx)
    dk = np.asarray(top.dihedral_k)
    dn = np.asarray(top.dihedral_n)
    dp = np.asarray(top.dihedral_phase)
    out += ["", "[ dihedrals ]"]
    for r in range(len(didx)):
        a, b, c, d = (int(v) for v in didx[r])
        if dk[r] == 0 or max(a, b, c, d) >= n:
            continue
        out.append(f"{a + 1} {b + 1} {c + 1} {d + 1} 9 "
                   f"{dp[r] * DEG:.2f} {dk[r] * KCAL_TO_KJ:.4f} "
                   f"{int(dn[r])}")
    out += ["", "[ system ]", "molchanica-tpu export", "",
            "[ molecules ]", f"{mol_name} 1"]
    if asys.n_waters:
        out[-1:] = [f"{mol_name} 1", f"SOL {asys.n_waters}"]
        out.insert(0, '#include "oplsaa.ff/spc.itp"  '
                      '; replace with the matching 4-site water itp')
    return "\n".join(out) + "\n"


def make_gromacs_input(asys, cfg, n_steps: int, dt_ps: float,
                       out_dir, elements=None, prefix: str = "md"):
    """Write {prefix}.gro/.top/.mdp into out_dir (reference
    gromacs_input_from_state + input file export, src/gromacs/mod.rs:726)."""
    from .gro import write_gro

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    top = asys.topology
    n_real = top.n_atoms_real
    els = elements or ["C"] * n_real
    write_gro(out / f"{prefix}.gro", els,
              positions=np.asarray(asys.positions)[:n_real],
              box_extent=asys.box_extent)
    (out / f"{prefix}.top").write_text(make_top(asys))
    (out / f"{prefix}.mdp").write_text(make_mdp(cfg, n_steps, dt_ps))
    return out / f"{prefix}.mdp"


# ---------------------------------------------------------------------------
# Round trip: run grompp/mdrun and parse results back
# (reference launch_md / on_gromacs_md_complete, src/gromacs/mod.rs:593,660).
# Gated on a gmx binary being present (external_tools registry).
# ---------------------------------------------------------------------------

def run_gromacs_md(asys, cfg, n_steps: int, dt_ps: float, workdir,
                   timeout: int = 1800):
    """Write inputs, grompp, mdrun; returns GromacsRunResult.

    Requires the `gmx` binary (molchanica_tpu.external_tools.probe
    reports availability)."""
    import os

    from ..external_tools import run_tool

    os.makedirs(workdir, exist_ok=True)
    mdp = make_gromacs_input(asys, cfg, n_steps, dt_ps, out_dir=workdir)
    files = {ext: str(mdp.with_suffix("." + ext))
             for ext in ("mdp", "gro", "top")}
    r1 = run_tool("gromacs", [
        "grompp", "-f", files["mdp"], "-c", files["gro"],
        "-p", files["top"], "-o", os.path.join(workdir, "topol.tpr"),
        "-maxwarn", "4"], cwd=workdir, timeout=timeout)
    if r1.returncode != 0:
        raise RuntimeError(f"grompp failed:\n{r1.stderr[-2000:]}")
    r2 = run_tool("gromacs", [
        "mdrun", "-deffnm", "topol", "-nt", "1"], cwd=workdir,
        timeout=timeout)
    if r2.returncode != 0:
        raise RuntimeError(f"mdrun failed:\n{r2.stderr[-2000:]}")
    log = open(os.path.join(workdir, "topol.log")).read()
    energies = parse_gromacs_log_energies(log)
    out_gro = os.path.join(workdir, "topol.gro")
    return GromacsRunResult(energies=energies, log_path=os.path.join(
        workdir, "topol.log"), structure_path=out_gro)


class GromacsRunResult:
    def __init__(self, energies, log_path, structure_path):
        self.energies = energies          # list of per-report dicts
        self.log_path = log_path
        self.structure_path = structure_path

    @property
    def final_potential_kcal(self):
        if not self.energies:
            return None
        kj = self.energies[-1].get("Potential")
        return None if kj is None else kj / 4.184


def parse_gromacs_log_energies(log_text: str):
    """Parse the 'Energies (kJ/mol)' tables from an mdrun .log.

    Returns a list of {term: value} dicts (chronological). The table
    layout is two related lines: names row(s) then values row(s)."""
    out = []
    lines = log_text.splitlines()
    i = 0
    while i < len(lines):
        if lines[i].strip().startswith("Energies (kJ/mol)"):
            i += 1
            terms = {}
            while i + 1 < len(lines):
                names_ln = lines[i]
                vals_ln = lines[i + 1]
                # names are fixed-width 15-char columns
                names = [names_ln[c:c + 15].strip()
                         for c in range(0, len(names_ln), 15)]
                names = [n for n in names if n]
                try:
                    vals = [float(v) for v in vals_ln.split()]
                except ValueError:
                    break
                if not names or len(vals) != len(names):
                    break
                terms.update(dict(zip(names, vals)))
                i += 2
            if terms:
                out.append(terms)
        else:
            i += 1
    return out
