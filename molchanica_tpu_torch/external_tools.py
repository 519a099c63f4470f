"""External-tools registry: discovery, availability, invocation.

Copy of molchanica_tpu.external_tools:
the same host code, so its results equal the reference's bit for bit.

Reference parity: src/external_tools/mod.rs — a registry of external
programs (GROMACS, ORCA, LigandMPNN, ANARCI, IgBLAST...) with per-tool
specs (kind, how to install, availability probing) and managed
invocation. Installation management is environment-specific; this
registry covers the discovery/availability/run surface so workloads can
gate on tool presence uniformly.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional, Sequence


class ToolKind(Enum):
    MD_ENGINE = "md_engine"
    QM = "qm"
    SEQUENCE = "sequence"
    STRUCTURE_ML = "structure_ml"


@dataclass(frozen=True)
class ToolSpec:
    name: str
    kind: ToolKind
    executables: tuple                 # candidate binary names
    description: str = ""
    version_args: tuple = ("--version",)
    pip_package: Optional[str] = None  # installable into a managed venv


REGISTRY: Dict[str, ToolSpec] = {
    "gromacs": ToolSpec(
        "gromacs", ToolKind.MD_ENGINE, ("gmx", "gmx_mpi"),
        "GROMACS MD engine (grompp/mdrun round trips)"),
    "orca": ToolSpec(
        "orca", ToolKind.QM, ("orca",),
        "ORCA quantum chemistry", version_args=()),
    "anarci": ToolSpec(
        "anarci", ToolKind.SEQUENCE, ("ANARCI", "anarci"),
        "antibody numbering"),
    "igblast": ToolSpec(
        "igblast", ToolKind.SEQUENCE, ("igblastn", "igblastp"),
        "immunoglobulin BLAST"),
    "ligandmpnn": ToolSpec(
        "ligandmpnn", ToolKind.STRUCTURE_ML, ("ligandmpnn",),
        "LigandMPNN sequence design"),
    "anarcii": ToolSpec(
        "anarcii", ToolKind.SEQUENCE, ("anarcii",),
        "ANARCII antibody numbering", pip_package="anarcii"),
    "mdtraj": ToolSpec(
        "mdtraj", ToolKind.MD_ENGINE, ("mdconvert",),
        "MDTraj trajectory conversion", pip_package="mdtraj"),
    # structure-prediction backends (reference: src/structure_prediction/
    # mod.rs — third-party models driven through the registry, never a bare
    # PATH assumption; a missing model never prevents startup)
    "boltz2": ToolSpec(
        "boltz2", ToolKind.STRUCTURE_ML, ("boltz",),
        "Boltz-2 structure + affinity prediction", pip_package="boltz"),
    "esmfold": ToolSpec(
        "esmfold", ToolKind.STRUCTURE_ML, ("esm-fold",),
        "ESMFold protein structure prediction", pip_package="fair-esm"),
    "opendde": ToolSpec(
        "opendde", ToolKind.STRUCTURE_ML, ("opendde",),
        "OpenDDE structure prediction"),
}


def _env_override(name: str) -> Optional[str]:
    """Explicit executable override, reference-style env vars
    (MOLCHANICA_ORCA_EXECUTABLE etc., README.md:80-103)."""
    return os.environ.get(f"MOLCHANICA_TPU_{name.upper()}_EXECUTABLE")


def managed_dir(name: str) -> str:
    """Per-tool managed install root (the analog of the reference's
    uv-managed per-tool venvs, external_tools/mod.rs:22-39)."""
    root = os.environ.get(
        "MOLCHANICA_TPU_TOOLS_DIR",
        os.path.join(os.path.expanduser("~"), ".molchanica_tpu", "tools"))
    return os.path.join(root, name)


def install(name: str, timeout: int = 1800) -> str:
    """Install a pip-installable tool into its managed venv (reference
    install flow, external_tools/mod.rs:319-399). Uses `uv` when present,
    stdlib venv + pip otherwise. Requires network access; raises with a
    clear message when the tool has no pip package."""
    spec = REGISTRY[name]
    if not spec.pip_package:
        raise RuntimeError(
            f"{name} has no managed pip package; install it system-wide "
            f"(looked for {spec.executables}) or set "
            f"MOLCHANICA_TPU_{name.upper()}_EXECUTABLE")
    venv = managed_dir(name)
    os.makedirs(os.path.dirname(venv), exist_ok=True)
    uv = shutil.which(os.environ.get("MOLCHANICA_TPU_UV", "uv"))
    if uv:
        cmds = [[uv, "venv", venv],
                [uv, "pip", "install", "--python",
                 os.path.join(venv, "bin", "python"), spec.pip_package]]
    else:
        import sys
        cmds = [[sys.executable, "-m", "venv", venv],
                [os.path.join(venv, "bin", "python"), "-m", "pip",
                 "install", spec.pip_package]]
    for cmd in cmds:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout)
        if r.returncode != 0:
            raise RuntimeError(
                f"install of {name} failed at {' '.join(cmd[:3])}: "
                f"{(r.stderr or r.stdout)[-500:]}")
    return venv


def uninstall(name: str) -> bool:
    """Remove a managed install; True if something was removed."""
    venv = managed_dir(name)
    if os.path.isdir(venv):
        shutil.rmtree(venv)
        return True
    return False


@dataclass
class ToolStatus:
    spec: ToolSpec
    available: bool
    path: Optional[str] = None
    version: Optional[str] = None


def probe(name: str) -> ToolStatus:
    """Availability + version of one registered tool. Resolution order:
    env-var override, managed venv, PATH."""
    spec = REGISTRY[name]
    override = _env_override(name)
    candidates = [override] if override else []
    mbin = os.path.join(managed_dir(name), "bin")
    for exe in spec.executables:
        candidates.append(os.path.join(mbin, exe))
        candidates.append(exe)
    for exe in candidates:
        path = shutil.which(exe) if os.sep not in exe else (
            exe if os.path.isfile(exe) and os.access(exe, os.X_OK)
            else None)
        if path:
            version = None
            if spec.version_args:
                try:
                    r = subprocess.run(
                        [path, *spec.version_args], capture_output=True,
                        text=True, timeout=10)
                    version = (r.stdout or r.stderr).splitlines()[0][:120] \
                        if (r.stdout or r.stderr) else None
                except Exception:
                    pass
            return ToolStatus(spec, True, path, version)
    return ToolStatus(spec, False)


def available_tools() -> List[str]:
    return [n for n in REGISTRY if probe(n).available]


def require(name: str) -> str:
    """Path of a required tool, or a clear error."""
    st = probe(name)
    if not st.available:
        raise RuntimeError(
            f"external tool {name!r} ({st.spec.description}) is not "
            f"installed; looked for {st.spec.executables}")
    return st.path


def run_tool(name: str, args: Sequence[str], cwd=None, timeout=600,
             env: Optional[dict] = None) -> subprocess.CompletedProcess:
    """Managed invocation (captured output, bounded runtime)."""
    path = require(name)
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    return subprocess.run([path, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout, env=full_env)
