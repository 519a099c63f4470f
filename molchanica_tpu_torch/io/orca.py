"""ORCA QM input generation and output parsing.

Copy of molchanica_tpu.io.orca:
the same host code, so its results equal the reference's bit for bit.

Counterpart of the reference application's src/orca.rs (+
bio_files::orca): build ORCA input files for the four task types the
reference exposes (single-point, geometry optimization, MBIS charges,
molecular dynamics — orca.rs TaskType,
:27-34), run them through the external-tools registry when an `orca`
binary exists, and parse the outputs back (final energy, optimized
geometry, MBIS charges, MD trajectory frames).

Recommended method defaults follow the ORCA quickstart recommendations the
reference links (r2SCAN-3c for general work).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

HARTREE_TO_KCAL = 627.5094740631

TASK_KEYWORDS = {
    "single_point": "SP",
    "geometry_optimization": "Opt",
    "mbis_charges": "SP",          # MBIS requested via %output block
    "mol_dynamics": "MD",
}


@dataclass
class OrcaTask:
    """One ORCA job description (orca.rs StateOrca/TaskType)."""
    task: str = "geometry_optimization"
    method: str = "r2SCAN-3c"      # quickstart recommendation
    charge: int = 0
    multiplicity: int = 1
    n_procs: int = 1
    # MD-only (orca.rs MolDynamics: "uses settings from the MD section")
    md_steps: int = 200
    md_dt_fs: float = 0.5
    md_temp_k: float = 300.0
    extra_keywords: List[str] = field(default_factory=list)


def make_input(elements, positions, task: OrcaTask) -> str:
    """Build the ORCA .inp text for a molecule + task."""
    if task.task not in TASK_KEYWORDS:
        raise ValueError(f"unknown ORCA task {task.task!r}")
    kw = [task.method, TASK_KEYWORDS[task.task]] + list(task.extra_keywords)
    lines = ["! " + " ".join(kw)]
    if task.n_procs > 1:
        lines.append(f"%pal nprocs {task.n_procs} end")
    if task.task == "mbis_charges":
        lines.append("%output Print[P_MBIS_Charges] 1 end")
    if task.task == "mol_dynamics":
        lines.append("%md")
        lines.append(f"  timestep {task.md_dt_fs}_fs")
        lines.append(f"  initvel {task.md_temp_k}_K")
        lines.append(f"  thermostat berendsen {task.md_temp_k}_K "
                     "timecon 10.0_fs")
        lines.append("  dump position stride 1 filename \"trajectory.xyz\"")
        lines.append(f"  run {int(task.md_steps)}")
        lines.append("end")
    lines.append(f"* xyz {task.charge} {task.multiplicity}")
    for e, p in zip(elements, np.asarray(positions)):
        lines.append(f"  {e:2s} {p[0]:14.8f} {p[1]:14.8f} {p[2]:14.8f}")
    lines.append("*")
    return "\n".join(lines) + "\n"


def parse_final_energy(text: str) -> Optional[float]:
    """FINAL SINGLE POINT ENERGY in kcal/mol (None if absent)."""
    m = None
    for m in re.finditer(r"FINAL SINGLE POINT ENERGY\s+(-?\d+\.\d+)", text):
        pass
    return float(m.group(1)) * HARTREE_TO_KCAL if m else None


def parse_optimized_geometry(text: str):
    """Last CARTESIAN COORDINATES (ANGSTROEM) block ->
    (elements, positions [n,3]) or None."""
    blocks = re.findall(
        r"CARTESIAN COORDINATES \(ANGSTROEM\)\n-+\n((?:\s*\w+\s+-?[\d.]+"
        r"\s+-?[\d.]+\s+-?[\d.]+\n)+)", text)
    if not blocks:
        return None
    elems, pos = [], []
    for line in blocks[-1].strip().splitlines():
        parts = line.split()
        elems.append(parts[0])
        pos.append([float(v) for v in parts[1:4]])
    return elems, np.asarray(pos)


def parse_mbis_charges(text: str) -> Optional[np.ndarray]:
    """MBIS charge table -> [n] charges or None."""
    m = re.search(
        r"MBIS ANALYSIS.*?ATOM\s+CHARGE.*?\n((?:\s*\d+\s+\w+\s+-?[\d.]+"
        r".*\n)+)", text, re.S)
    if not m:
        return None
    qs = []
    for line in m.group(1).strip().splitlines():
        parts = line.split()
        qs.append(float(parts[2]))
    return np.asarray(qs)


def parse_xyz_trajectory(text: str):
    """Multi-frame XYZ (ORCA MD 'trajectory.xyz') -> list of
    (elements, positions). Feeds the Snapshot pipeline like the
    reference's update_snapshots (orca.rs:68-92)."""
    lines = text.splitlines()
    frames = []
    i = 0
    while i < len(lines):
        try:
            n = int(lines[i].strip())
        except (ValueError, IndexError):
            break
        block = lines[i + 2:i + 2 + n]
        elems, pos = [], []
        for ln in block:
            parts = ln.split()
            elems.append(parts[0])
            pos.append([float(v) for v in parts[1:4]])
        frames.append((elems, np.asarray(pos)))
        i += 2 + n
    return frames


def run_orca(elements, positions, task: OrcaTask, workdir=None,
             timeout_s: float = 3600.0):
    """Write the input, run `orca` (external-tools registry path), parse.

    Returns a dict with whatever the task produces; raises RuntimeError if
    the orca binary is unavailable (probe via external_tools registry
    first, matching the reference's IntegrationsAvail gating)."""
    import shutil
    import subprocess
    import tempfile
    from pathlib import Path

    exe = shutil.which("orca")
    if exe is None:
        raise RuntimeError("orca binary not found on PATH")
    wd = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="orca_"))
    wd.mkdir(parents=True, exist_ok=True)
    inp = wd / "job.inp"
    inp.write_text(make_input(elements, positions, task))
    r = subprocess.run([exe, str(inp)], capture_output=True, text=True,
                       timeout=timeout_s, cwd=wd)
    out = r.stdout
    (wd / "job.out").write_text(out)
    result = {"workdir": str(wd), "returncode": r.returncode,
              "energy_kcal": parse_final_energy(out)}
    if task.task == "geometry_optimization":
        result["geometry"] = parse_optimized_geometry(out)
    if task.task == "mbis_charges":
        result["mbis_charges"] = parse_mbis_charges(out)
    if task.task == "mol_dynamics":
        traj = wd / "trajectory.xyz"
        if traj.exists():
            result["trajectory"] = parse_xyz_trajectory(traj.read_text())
    return result
