"""Headless CLI: PyMol-style commands + framework verbs (port of
molchanica_tpu.cli).

Reference parity: src/cli.rs (PyMol-syntax command line: help/fetch/save/
load/show/select resn|resi|elem/remove/pwd/ls/cd) re-targeted at a headless
terminal. Camera/render verbs (orient/turn/zoom/png) drive the headless
renderer (render.py) instead of a swapchain; move/rotate are the headless
mol-manipulation analog (ref src/mol_manip.rs); the framework verbs expose
the actual compute surface (energy, minimize, md, characterize, predict...).

Run `python -m molchanica_tpu_torch` for a REPL, or pass commands:
`python -m molchanica_tpu_torch "load mol.sdf" "energy"`. The session's
device work (energy, minimize, md, predict, png, background tasks) runs
on `CliState.device`: None, the default, means the CUDA card; tests pass
"cpu" (`main(argv, device="cpu")`). Session files are the JAX package's
JSON, so a session saved by either package loads in the other.
"""
from __future__ import annotations

import json
import os
import re
import shlex
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

HELP = """\
Commands (PyMol-style where applicable):
  help                        this text
  load <path>                 open a structure (sdf/mol2/pdb/cif/xyz/gro/smiles:<s>)
  save <path>                 write the active molecule (format by extension)
  fetch <name>                load from the embedded mol DBs (e.g. fetch glucose)
  ls / pwd / cd <dir>         file navigation
  show [sel]                  summary of the active molecule / selection
  select resn <name>          select by residue name
  select resi <range>         select by residue id (e.g. 10-20)
  select elem <El>            select by element
  remove <sel|selection>      delete selected atoms from the active mol
  energy                      single-point energy of the active molecule
  minimize [n]                FIRE relaxation (default 200 iters)
  md [n_steps] [dt_ps]        short vacuum MD (default 1000 x 0.001)
  characterize                descriptors (MW, TPSA, cLogP, rings, ...)
  predict <target> <smiles>   therapeutic-model prediction
  targets                     list trained therapeutic targets
  turn <x|y|z> <deg>          orbit the camera about an axis
  zoom <factor>               zoom the camera (>1 in, <1 out)
  orient / reset              frame the camera on the active molecule
  move <dx> <dy> <dz>         translate the active molecule (A)
  rotate <x|y|z> <deg>        rotate the active molecule about its centroid
  png <path> [mode]           render to an image (ball_stick|sticks|spheres|
                              backbone|points)
  bg <cmd>                    run any command in the background
  tasks                       poll background tasks (drain finished)
  wait <name>                 block on one background task
  session save|load [path]    persist/restore the session
  quit / exit
"""


@dataclass
class CliState:
    """Session state (reference State analog, headless subset)."""
    mols: Dict[str, object] = field(default_factory=dict)   # name -> MoleculeCommon
    active: Optional[str] = None
    selection: Optional[List[int]] = None
    history: List[str] = field(default_factory=list)
    tasks: object = None     # lazy TaskRegistry (reference ThreadReceivers)
    camera: object = None    # lazy render.Camera (reference arc cam)
    device: object = None    # where device work runs (None: the CUDA card)

    def get_camera(self):
        if self.camera is None:
            from .render import Camera
            self.camera = Camera()
            self._cam_framed = False
        return self.camera

    def task_registry(self):
        if self.tasks is None:
            from .tasks import TaskRegistry
            self.tasks = TaskRegistry()
        return self.tasks

    def active_mol(self):
        if self.active is None:
            raise CliError("no molecule loaded (use: load <path>)")
        return self.mols[self.active]


class CliError(ValueError):
    pass


def handle_cmd(state: CliState, line: str) -> str:
    """Process one command; returns printable output (reference
    handle_cmd, src/cli.rs:59)."""
    line = line.strip()
    if not line:
        return ""
    state.history.append(line)
    low = line.lower()

    if re.match(r"^help$", low):
        return HELP
    if re.match(r"^pwd$", low):
        return os.getcwd()
    if re.match(r"^ls$", low):
        return "\n".join(sorted(os.listdir(".")))
    m = re.match(r"^cd\s+(.+)$", line, re.I)
    if m:
        os.chdir(os.path.expanduser(m.group(1).strip()))
        return os.getcwd()
    m = re.match(r"^fetch\s+(\S+)$", line, re.I)
    if m:
        return _fetch(state, m.group(1))
    m = re.match(r"^load\s+(.+)$", line, re.I)
    if m:
        return _load(state, m.group(1).strip())
    m = re.match(r"^save\s+(.+)$", line, re.I)
    if m:
        return _save(state, m.group(1).strip())
    m = re.match(r"^select\s+resn\s+(\w+)$", line, re.I)
    if m:
        return _select(state, "resn", m.group(1))
    m = re.match(r"^select\s+resi\s+([\d\-]+)$", line, re.I)
    if m:
        return _select(state, "resi", m.group(1))
    m = re.match(r"^select\s+elem\s+(\w+)$", line, re.I)
    if m:
        return _select(state, "elem", m.group(1))
    m = re.match(r"^select\s+(.+)$", line, re.I)
    if m:
        # full PyMol-style expression (selection.py): booleans, within,
        # byres, name/chain/index/hetatm/... — ref src/selection.rs
        return _select_expr(state, m.group(1).strip())
    if re.match(r"^remove\s+(sel|selection)$", low):
        return _remove_selection(state)
    m = re.match(r"^show(\s+.*)?$", line, re.I)
    if m:
        return _show(state)
    if re.match(r"^energy$", low):
        return _energy(state)
    m = re.match(r"^minimize(?:\s+(\d+))?$", low)
    if m:
        return _minimize(state, int(m.group(1) or 200))
    m = re.match(r"^md(?:\s+(\d+))?(?:\s+([\d.]+))?$", low)
    if m:
        return _md(state, int(m.group(1) or 1000),
                   float(m.group(2) or 0.001))
    if re.match(r"^characterize$", low):
        return _characterize(state)
    if re.match(r"^targets$", low):
        from .therapeutic import TherapeuticPredictor
        avail = TherapeuticPredictor.available()
        return "\n".join(avail) if avail else "(no trained targets)"
    m = re.match(r"^predict\s+(\S+)\s+(\S+)$", line, re.I)
    if m:
        from .therapeutic import TherapeuticPredictor
        pred = TherapeuticPredictor(m.group(1), device=state.device)
        val = pred.predict([m.group(2)])[0]
        return f"{m.group(1)}({m.group(2)}) = {val:.4f}"
    m = re.match(r"^turn\s+([xyz])\s+(-?[\d.]+)$", low)
    if m:
        cam = state.get_camera()
        deg = float(m.group(2))
        if m.group(1) == "y":
            cam.orbit(d_elevation_deg=deg)
        else:                       # x and z both orbit azimuthally
            cam.orbit(d_azimuth_deg=deg)
        return (f"camera: az={cam.azimuth_deg:.0f} "
                f"el={cam.elevation_deg:.0f} d={cam.distance:.1f}")
    m = re.match(r"^zoom\s+([\d.]+)$", low)
    if m:
        cam = state.get_camera()
        cam.zoom(float(m.group(1)))
        return f"camera: d={cam.distance:.1f}"
    if re.match(r"^(orient|reset)$", low):
        cam = state.get_camera()
        cam.azimuth_deg = cam.elevation_deg = 0.0
        cam.snap_to(np.asarray(state.active_mol().positions, float))
        state._cam_framed = True
        return (f"camera framed on {state.active} "
                f"(d={cam.distance:.1f})")
    m = re.match(r"^move\s+(-?[\d.]+)\s+(-?[\d.]+)\s+(-?[\d.]+)$", low)
    if m:
        mol = state.active_mol()
        shift = np.array([float(m.group(i)) for i in (1, 2, 3)])
        mol.positions = np.asarray(mol.positions, float) + shift
        return f"moved {state.active} by {shift.tolist()} A"
    m = re.match(r"^rotate\s+([xyz])\s+(-?[\d.]+)$", low)
    if m:
        mol = state.active_mol()
        ax, th = "xyz".index(m.group(1)), np.radians(float(m.group(2)))
        c, s = np.cos(th), np.sin(th)
        rot = np.eye(3)
        a, b = [(1, 2), (0, 2), (0, 1)][ax]
        rot[a, a] = rot[b, b] = c
        rot[a, b], rot[b, a] = -s, s
        cen = np.asarray(mol.positions, float).mean(axis=0)
        mol.positions = (np.asarray(mol.positions, float) - cen) @ rot.T + cen
        return f"rotated {state.active} {m.group(2)} deg about {m.group(1)}"
    m = re.match(r"^png\s+(\S+)(?:\s+(\w+))?$", line, re.I)
    if m:
        return _render_png(state, m.group(1), m.group(2) or "ball_stick")
    m = re.match(r"^bg\s+(.+)$", line, re.I)
    if m:
        return _bg(state, m.group(1).strip())
    if re.match(r"^tasks$", low):
        return _tasks(state)
    m = re.match(r"^wait\s+(\S+)$", line, re.I)
    if m:
        return _wait(state, m.group(1))
    m = re.match(r"^session\s+(save|load)(?:\s+(\S+))?$", line, re.I)
    if m:
        return _session(state, m.group(1).lower(),
                        m.group(2) or ".molchanica_session.json")
    raise CliError(f"unrecognized command: {line!r} (try `help`)")


# ---------------------------------------------------------------------------

def _fetch(state: CliState, name: str) -> str:
    """Offline fetch: look the name up in the embedded molecule DBs (the
    reference resolves HMDB/ChEBI names from its embedded parquet DBs;
    RCSB/PubChem download needs network and is unavailable here)."""
    from .mol_db import lookup_by_name
    from .molecules.embed import embed_3d
    from .molecules.smiles import from_smiles

    hit = lookup_by_name(name)
    if hit is None:
        raise CliError(
            f"fetch {name}: not in the embedded databases, and no network "
            "access in this environment; download the file and use `load`")
    db_name, row = hit
    mol = from_smiles(row.smiles)
    try:
        embed_3d(mol)
    except Exception:
        pass
    mol.name = row["name"]
    state.mols[row["name"]] = mol
    state.active = row["name"]
    state.selection = None
    return (f"fetched {row['name']} from {db_name}: {mol.n_atoms} atoms "
            f"(MW {row.mol_weight:.1f}, cLogP {row.clogp:.2f})")


def _load(state: CliState, path: str) -> str:
    from .molecules.smiles import from_smiles

    if path.lower().startswith("smiles:"):
        mol = from_smiles(path[7:])
        name = path[7:]
    else:
        from . import io as mio
        mol = mio.open_file(path)
        name = os.path.basename(path)
    state.mols[name] = mol
    state.active = name
    state.selection = None
    return f"loaded {name}: {mol.n_atoms} atoms"


def _save(state: CliState, path: str) -> str:
    from . import io as mio

    mol = state.active_mol()
    p = path.lower()
    if p.endswith(".sdf"):
        mio.write_sdf(mol, path)
    elif p.endswith(".mol2"):
        mio.write_mol2(mol, path)
    elif p.endswith(".pdb"):
        mio.write_pdb(mol, path)
    elif p.endswith(".xyz"):
        mio.write_xyz(mol, path)
    elif p.endswith(".cif") or p.endswith(".mmcif"):
        mio.write_mmcif(mol, path)
    else:
        raise CliError(f"unknown save format: {path}")
    return f"wrote {path}"


def _sel_name(state):
    n = len(state.selection or [])
    return f"({n} atoms selected)"


def _select(state: CliState, kind: str, value: str) -> str:
    mol = state.active_mol()
    if kind == "resn":
        names = mol.res_names or []
        sel = [i for i, r in enumerate(names) if r.upper() == value.upper()]
    elif kind == "resi":
        ids = mol.res_ids or []
        if "-" in value:
            a, b = value.split("-")
            lo, hi = int(a), int(b)
        else:
            lo = hi = int(value)
        sel = [i for i, r in enumerate(ids) if lo <= r <= hi]
    else:
        sel = [i for i, e in enumerate(mol.elements)
               if e.upper() == value.upper()]
    state.selection = sel
    return _sel_name(state)


def _select_expr(state: CliState, expr: str) -> str:
    from .selection import SelectionError, select_indices
    mol = state.active_mol()
    try:
        state.selection = select_indices(mol, expr)
    except SelectionError as e:
        raise CliError(f"selection: {e}")
    return _sel_name(state)


def _render_png(state: CliState, path: str, mode: str) -> str:
    """Render the active molecule through the session camera (the headless
    render() analog, ref src/render.rs:94)."""
    from .render import RenderStyle, Scene

    mol = state.active_mol()
    cam = state.get_camera()
    if not getattr(state, "_cam_framed", False):
        cam.snap_to(np.asarray(mol.positions, float))
        state._cam_framed = True
    sc = Scene(camera=cam, device=state.device)
    sc.add_mol(mol, RenderStyle(mode=mode))
    out = sc.render(path, title=getattr(mol, "name", "") or state.active)
    return f"wrote {out} ({mode}, {mol.n_atoms} atoms)"


def _remove_selection(state: CliState) -> str:
    mol = state.active_mol()
    if not state.selection:
        raise CliError("nothing selected")
    keep = [i for i in range(mol.n_atoms) if i not in set(state.selection)]
    remap = {old: new for new, old in enumerate(keep)}
    import copy
    m = copy.copy(mol)
    m.elements = [mol.elements[i] for i in keep]
    m.positions = np.asarray(mol.positions)[keep]
    m.bonds = [(remap[a], remap[b]) for a, b in mol.bonds
               if a in remap and b in remap]
    for attr in ("atom_names", "res_names", "res_ids", "chains", "hetero"):
        v = getattr(mol, attr, None)
        if v is not None:
            setattr(m, attr, [v[i] for i in keep])
    removed = mol.n_atoms - len(keep)
    state.mols[state.active] = m
    state.selection = None
    return f"removed {removed} atoms"


def _show(state: CliState) -> str:
    mol = state.active_mol()
    lines = [f"{state.active}: {mol.n_atoms} atoms, {len(mol.bonds)} bonds"]
    if mol.res_names:
        lines.append(f"residues: {len(set(zip(mol.res_ids, mol.chains)))}")
    if state.selection is not None:
        lines.append(_sel_name(state))
    return "\n".join(lines)


def _to_spec(mol):
    return mol.to_spec(strict=False)


ENERGY_TERMS = ("bond", "angle", "dihedral", "lj", "coulomb",
                "energy_potential")


def energy_terms(state: CliState) -> dict:
    """`energy`'s terms of the active molecule (float64, kcal/mol)."""
    from .md.config import Integrator, MdConfig
    from .md.engine import compute_energy_snapshot
    from .molecules.spec import assemble_system

    asys = assemble_system([_to_spec(state.active_mol())])
    cfg = MdConfig(integrator=Integrator.verlet_velocity(),
                   dtype="float64", max_init_relaxation_iters=None)
    snap = compute_energy_snapshot(asys.topology, cfg, asys.positions,
                                   device=state.device)
    return {k: snap[k] for k in ENERGY_TERMS if k in snap}


def _energy(state: CliState) -> str:
    return "\n".join(f"{k:>18s}: {v:12.4f} kcal/mol"
                     for k, v in energy_terms(state).items())


def _minimize(state: CliState, n: int) -> str:
    from .md.config import Integrator, MdConfig
    from .md.engine import MdSim
    from .molecules.spec import assemble_system

    mol = state.active_mol()
    asys = assemble_system([_to_spec(mol)])
    cfg = MdConfig(integrator=Integrator.verlet_velocity(),
                   dtype="float64", max_init_relaxation_iters=n)
    sim = MdSim(asys.topology, cfg, asys.positions, device=state.device)
    x = sim.state.positions.cpu().numpy()[: mol.n_atoms]
    mol.positions = x
    return f"minimized {n} iters; E = {float(sim.state.pe_last):.4f}"


def _md(state: CliState, n_steps: int, dt: float) -> str:
    from .md.config import HydrogenConstraint, Integrator, MdConfig
    from .md.engine import MdSim
    from .molecules.spec import assemble_system

    mol = state.active_mol()
    asys = assemble_system([_to_spec(mol)])
    cfg = MdConfig(integrator=Integrator.langevin_middle(gamma=2.0),
                   temp_target=300.0,
                   hydrogen_constraint=HydrogenConstraint.flexible(),
                   dtype="float64", max_init_relaxation_iters=200)
    sim = MdSim(asys.topology, cfg, asys.positions, device=state.device)
    sim.step(dt, n_steps)
    mol.positions = sim.state.positions.cpu().numpy()[: mol.n_atoms]
    return (f"ran {n_steps} x {dt} ps: T = {sim.temperature():.1f} K, "
            f"E = {float(sim.state.pe_last):.4f} kcal/mol")


def _bg(state: CliState, sub: str) -> str:
    """Launch a command in the background (reference: every expensive
    action runs on a worker thread with an mpsc channel polled per frame,
    src/threads.rs:32-59; here: `bg <cmd>` + `tasks` to poll, `wait <name>`
    to join). The task runs against a snapshot of the current CliState so
    the foreground session stays consistent. The task runs on the
    session's device; a CUDA device's index is fixed here, in the calling
    thread."""
    import copy

    from .device import resolve_device

    dev = resolve_device(state.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    reg = state.task_registry()
    snap = CliState(mols=dict(state.mols), active=state.active,
                    selection=(list(state.selection)
                               if state.selection else None),
                    device=dev)
    # background MD mutates its own copy of the molecule; the result is
    # merged into the live session when the task is collected via `tasks`
    if snap.active is not None:
        snap.mols[snap.active] = copy.copy(state.mols[state.active])
    kind = sub.split()[0]

    def work():
        out = handle_cmd(snap, sub)
        return out, snap

    h = reg.submit(kind, work,
                   cuda_device=dev if dev.type == "cuda" else None)
    return f"launched task {h.name!r} (`tasks` to poll, `wait {h.name}`)"


def _collect(state: CliState, name: str, handle) -> str:
    out, snap = handle.result
    # merge molecule mutations (e.g. bg md moved the active mol) back
    for k, v in snap.mols.items():
        state.mols[k] = v
    return f"[{name} done in {handle.elapsed_s:.1f}s]\n{out}"


def _tasks(state: CliState) -> str:
    reg = state.task_registry()
    lines = []
    for name, h in reg.poll():
        if h.error is not None:
            lines.append(f"[{name} FAILED] {h.error}")
        else:
            lines.append(_collect(state, name, h))
    for h in reg.running():
        lines.append(f"[{h.name} running {h.elapsed_s:.1f}s]")
    return "\n".join(lines) if lines else "(no tasks)"


def _wait(state: CliState, name: str) -> str:
    from .tasks import TaskError

    reg = state.task_registry()
    try:
        h = reg.get(name)
    except KeyError as e:
        raise CliError(str(e))
    try:
        h.join()
    except TaskError as e:
        return f"[{name} FAILED] {e}"
    drained = dict(reg.poll())           # consume its completion record
    for other, oh in drained.items():
        if other != name and oh.error is None:
            _collect(state, other, oh)
    return _collect(state, name, h)


def _characterize(state: CliState) -> str:
    from .molecules.characterization import characterize

    ch = characterize(state.active_mol())
    return "\n".join([
        f"        MW: {ch.mol_weight:.2f}",
        f"      TPSA: {ch.tpsa:.2f}",
        f"     cLogP: {ch.clogp:.3f}",
        f"     rings: {len(ch.rings)} ({ch.n_aromatic_rings} aromatic)",
        f" rotatable: {len(ch.rotatable_bonds)}",
        f"       HBD: {ch.h_bond_donors}  HBA: {ch.h_bond_acceptors}",
    ])


def _session(state: CliState, verb: str, path: str) -> str:
    """Session persistence (reference prefs/session layer analog)."""
    if verb == "save":
        blob = {"active": state.active, "history": state.history[-200:],
                "mols": {}}
        for name, mol in state.mols.items():
            blob["mols"][name] = {
                "elements": list(mol.elements),
                "positions": np.asarray(mol.positions).tolist(),
                "bonds": [list(map(int, b)) for b in mol.bonds],
                "atom_names": mol.atom_names,
                "res_names": mol.res_names,
                "res_ids": mol.res_ids,
                "chains": mol.chains,
            }
        with open(path, "w") as f:
            json.dump(blob, f)
        return f"session saved to {path}"
    blob = json.load(open(path))
    from .molecules.common import MoleculeCommon
    state.mols = {}
    for name, m in blob["mols"].items():
        state.mols[name] = MoleculeCommon(
            elements=m["elements"], positions=np.asarray(m["positions"]),
            bonds=[tuple(b) for b in m["bonds"]],
            atom_names=m.get("atom_names"), res_names=m.get("res_names"),
            res_ids=m.get("res_ids"), chains=m.get("chains"))
    state.active = blob.get("active")
    state.history = blob.get("history", [])
    return f"session loaded from {path} ({len(state.mols)} molecules)"


def main(argv=None, device=None) -> int:
    """Run `argv`'s commands in order (batch mode: a CliError prints and
    exits 1, any other exception propagates) or, with none, the REPL
    (which prints any exception and goes on). Device work runs on
    `device` (None: the CUDA card)."""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    state = CliState(device=device)
    if argv:
        for cmd in argv:
            try:
                out = handle_cmd(state, cmd)
                if out:
                    print(out)
            except CliError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        return 0
    print("molchanica-tpu CLI — `help` for commands, `quit` to exit")
    while True:
        # pre-prompt poll: surface finished background tasks (reference
        # polls its thread receivers once per frame, src/threads.rs:77)
        if state.tasks is not None:
            for name, h in state.tasks.poll():
                if h.error is not None:
                    print(f"[{name} FAILED] {h.error}")
                else:
                    print(_collect(state, name, h))
        try:
            line = input("molc> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip().lower() in ("quit", "exit"):
            break
        try:
            out = handle_cmd(state, line)
            if out:
                print(out)
        except CliError as e:
            print(f"error: {e}")
        except Exception as e:          # keep the REPL alive
            print(f"error: {type(e).__name__}: {e}")
    return 0
