"""Port parity of the host tool wrappers (molchanica_tpu_torch.
external_tools, .io.gromacs, .io.orca, .analysis.hbonds) against
molchanica_tpu's, on the CPU. No external binary runs: subprocess.run,
shutil.which and run_tool are mocked, as the JAX package's own tests do.

Tolerances: every text, path, command line and parsed value is held
exactly (the wrappers are host copies); the H-bond lists field by field.
The one departure: the port's run_gromacs_md runs grompp and mdrun on
make_gromacs_input's files, where the reference's raises (it indexes the
returned .mdp path as a dict).
"""
import dataclasses
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

from molchanica_tpu import external_tools as JT
from molchanica_tpu.analysis import hbonds as JH
from molchanica_tpu.io import gromacs as JG
from molchanica_tpu.io import orca as JO
from molchanica_tpu.md import config as JCfg
from molchanica_tpu.molecules import smiles as JS
from molchanica_tpu.molecules import spec as JSpec
from molchanica_tpu.systems import water as JW
from molchanica_tpu_torch import external_tools as TT
from molchanica_tpu_torch.analysis import hbonds as TH
from molchanica_tpu_torch.io import gromacs as TG
from molchanica_tpu_torch.io import orca as TO
from molchanica_tpu_torch.md import config as TCfg
from molchanica_tpu_torch.molecules import smiles as TS
from molchanica_tpu_torch.molecules import spec as TSpec
from molchanica_tpu_torch.systems import water as TW

WATER = (["O", "H", "H"],
         np.array([[0.0, 0.0, 0.0], [0.96, 0.0, 0.0], [-0.24, 0.93, 0.0]]))
ORCA_OUT = """
some header
FINAL SINGLE POINT ENERGY      -76.32894512
...
CARTESIAN COORDINATES (ANGSTROEM)
---------------------------------
  O      0.000000    0.000000    0.000000
  H      0.961000    0.010000    0.000000
  H     -0.240000    0.930000    0.000000

FINAL SINGLE POINT ENERGY      -76.32991040
"""
MBIS_OUT = """
MBIS ANALYSIS
--------------
  ATOM   CHARGE    ...
   0 O   -0.68210   1.0
   1 H    0.34105   1.0
   2 H    0.34105   1.0
"""
XYZ_TRAJ = """3
frame 0
O 0.0 0.0 0.0
H 0.9 0.0 0.0
H -0.2 0.9 0.0
3
frame 1
O 0.0 0.0 0.1
H 0.9 0.0 0.1
H -0.2 0.9 0.1
"""
GMX_LOG = """stuff
   Energies (kJ/mol)
           Bond          Angle    Proper Dih.          LJ-14     Coulomb-14
    1.00000e+00    2.00000e+00    3.00000e+00    4.00000e+00    5.00000e+00
        LJ (SR)   Coulomb (SR)   Coul. recip.      Potential    Kinetic En.
    6.00000e+00   -7.00000e+00    8.00000e+00    9.00000e+00    1.00000e+01
more
   Energies (kJ/mol)
           Bond          Angle      Potential
    4.00000e+00    5.00000e+00   -4.18400e+02
"""


# --------------------------------------------------------------------------
# the external-tools registry

def test_registry_matches_reference(tmp_path, monkeypatch):
    assert TT.REGISTRY.keys() == JT.REGISTRY.keys()
    for name, spec in TT.REGISTRY.items():
        ref = JT.REGISTRY[name]
        assert (spec.name, spec.kind.value, spec.executables,
                spec.description, spec.version_args, spec.pip_package) == \
            (ref.name, ref.kind.value, ref.executables, ref.description,
             ref.version_args, ref.pip_package)
    monkeypatch.setenv("MOLCHANICA_TPU_TOOLS_DIR", str(tmp_path))
    assert TT.managed_dir("anarcii") == JT.managed_dir("anarcii") \
        == str(tmp_path / "anarcii")


class _Runs:
    """A stand-in for subprocess.run that records each command and answers
    with the given return code and output."""
    def __init__(self, returncode=0, stdout="fake 2024.1\n", stderr=""):
        self.calls = []
        self.out = (returncode, stdout, stderr)

    def __call__(self, cmd, **kw):
        self.calls.append((list(cmd), {k: v for k, v in kw.items()
                                       if k != "env"}, kw.get("env")))
        rc, so, se = self.out
        return subprocess.CompletedProcess(cmd, rc, so, se)


def test_probe_require_and_run_tool_match_reference(tmp_path, monkeypatch):
    """The env-var override wins the probe, a managed-venv binary resolves
    without PATH, require reports a missing tool, and run_tool passes the
    same command line, options and environment."""
    monkeypatch.setenv("MOLCHANICA_TPU_TOOLS_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    fake = tmp_path / "fake_gmx"
    fake.write_text("#!/bin/sh\necho fake\n")
    fake.chmod(0o755)
    monkeypatch.setenv("MOLCHANICA_TPU_GROMACS_EXECUTABLE", str(fake))
    mbin = tmp_path / "mdtraj" / "bin"
    mbin.mkdir(parents=True)
    (mbin / "mdconvert").write_text("#!/bin/sh\necho 1.0\n")
    (mbin / "mdconvert").chmod(0o755)
    runs = {}
    for tag, mod in (("ref", JT), ("port", TT)):
        runs[tag] = _Runs()
        monkeypatch.setattr(subprocess, "run", runs[tag])
        out = []
        for name in ("gromacs", "mdtraj", "orca"):
            st = mod.probe(name)
            out.append((st.spec.name, st.available, st.path, st.version))
        out.append(mod.available_tools())
        out.append(mod.require("gromacs"))
        with pytest.raises(RuntimeError, match="orca") as e:
            mod.require("orca")
        out.append(str(e.value))
        r = mod.run_tool("gromacs", ["grompp", "-f", "md.mdp"],
                         cwd=str(tmp_path), timeout=60, env={"OMP": "1"})
        out.append((r.returncode, r.stdout))
        runs[tag] = (out, runs[tag].calls)
    assert runs["port"] == runs["ref"]
    out, calls = runs["port"]
    assert out[0] == ("gromacs", True, str(fake), "fake 2024.1")
    assert out[1][2] == str(mbin / "mdconvert") and not out[2][1]
    assert calls[-1][0] == [str(fake), "grompp", "-f", "md.mdp"]
    assert calls[-1][2]["OMP"] == "1"


@pytest.mark.parametrize("uv", [False, True])
def test_install_and_uninstall_match_reference(tmp_path, monkeypatch, uv):
    """install's commands (uv, or stdlib venv + pip), its failure message,
    the refusal of a tool without a pip package, and uninstall."""
    monkeypatch.setenv("MOLCHANICA_TPU_TOOLS_DIR", str(tmp_path))
    fake_uv = tmp_path / "uv"
    fake_uv.write_text("#!/bin/sh\n")
    fake_uv.chmod(0o755)
    monkeypatch.setenv("MOLCHANICA_TPU_UV",
                       str(fake_uv) if uv else str(tmp_path / "no_uv"))
    got = {}
    for tag, mod in (("ref", JT), ("port", TT)):
        ok, bad = _Runs(), _Runs(returncode=1, stderr="no network")
        monkeypatch.setattr(subprocess, "run", ok)
        venv = mod.install("anarcii", timeout=5)
        monkeypatch.setattr(subprocess, "run", bad)
        with pytest.raises(RuntimeError) as e:
            mod.install("mdtraj")
        with pytest.raises(RuntimeError, match="no managed pip package"):
            mod.install("gromacs")
        os.makedirs(venv, exist_ok=True)
        removed = (mod.uninstall("anarcii"), mod.uninstall("anarcii"))
        got[tag] = (venv, ok.calls, bad.calls, str(e.value), removed)
    assert got["port"] == got["ref"]
    venv, calls, _, msg, removed = got["port"]
    assert venv == str(tmp_path / "anarcii") and removed == (True, False)
    assert len(calls) == 2 and "no network" in msg
    assert (calls[0][0][0] == str(fake_uv)) == uv


# --------------------------------------------------------------------------
# GROMACS

def _configs(mod):
    """MdConfigs that reach every branch of make_mdp."""
    return [
        mod.MdConfig(),
        mod.MdConfig(integrator=mod.Integrator.langevin_middle(gamma=2.0),
                     zero_com_drift=False),
        mod.MdConfig(integrator=mod.Integrator.verlet_velocity(0.1),
                     barostat_cfg=mod.BarostatCfg(),
                     hydrogen_constraint=mod.HydrogenConstraint.linear()),
        mod.MdConfig(integrator=mod.Integrator.leapfrog(None),
                     coulomb_cutoff=10.0, lj_cutoff=8.0),
    ]


@pytest.fixture(scope="module")
def systems():
    """Butanol in a 20 A box, and with 40 OPC waters, assembled by each
    package from its own from_smiles."""
    out = {}
    for tag, smiles, spec, water in (("ref", JS, JSpec, JW),
                                     ("port", TS, TSpec, TW)):
        mol = smiles.from_smiles("CCCCO")
        s = mol.to_spec(strict=False)
        box = np.array([20.0] * 3)
        out[tag] = (mol, [
            spec.assemble_system([s], box_extent=box),
            spec.assemble_system([s], box_extent=box, water_model=water.OPC,
                                 n_waters=40, seed=2)])
    return out


def test_gromacs_texts_match_reference(systems, tmp_path):
    """make_mdp over each config branch and make_gromacs_input's .gro, .top
    and .mdp for the same assembled systems, byte for byte."""
    for cj, ct in zip(_configs(JCfg), _configs(TCfg)):
        for args in ((1000, 0.002), (50, 0.001, 10)):
            assert TG.make_mdp(ct, *args) == JG.make_mdp(cj, *args)
    (mj, sys_j), (mt, sys_t) = systems["ref"], systems["port"]
    cfg_j = _configs(JCfg)[2]
    cfg_t = _configs(TCfg)[2]
    for k, (aj, at) in enumerate(zip(sys_j, sys_t)):
        assert TG.make_top(at, "LIG") == JG.make_top(aj, "LIG")
        els = None if k else mt.elements
        pj = JG.make_gromacs_input(aj, cfg_j, 1000, 0.002, tmp_path / f"j{k}",
                                   elements=els)
        pt = TG.make_gromacs_input(at, cfg_t, 1000, 0.002, tmp_path / f"t{k}",
                                   elements=els, prefix="md")
        assert pt.name == pj.name == "md.mdp"
        for ext in ("gro", "top", "mdp"):
            assert (pt.parent / f"md.{ext}").read_bytes() == \
                (pj.parent / f"md.{ext}").read_bytes(), (k, ext)
    top = (tmp_path / "t1" / "md.top").read_text()
    assert top.rstrip().endswith(f"SOL {sys_t[1].n_waters}")


def test_gromacs_log_parse_matches_reference():
    got, ref = TG.parse_gromacs_log_energies(GMX_LOG), \
        JG.parse_gromacs_log_energies(GMX_LOG)
    assert got == ref and len(got) == 2 and len(got[0]) == 10
    res = TG.GromacsRunResult(got, "topol.log", "topol.gro")
    kcal = JG.GromacsRunResult(ref, "", "").final_potential_kcal
    assert res.final_potential_kcal == kcal and abs(kcal + 100.0) < 1e-12
    assert TG.GromacsRunResult([], "", "").final_potential_kcal is None


def test_run_gromacs_md_with_run_tool_mocked(systems, tmp_path,
                                            monkeypatch):
    """grompp then mdrun on make_gromacs_input's files, through run_tool,
    and the log's energies parsed back; a failing grompp raises. The
    reference's run_gromacs_md raises before its first run_tool call."""
    mt, sys_t = systems["port"]
    calls = []

    def run_tool(name, args, cwd=None, timeout=600, env=None):
        calls.append((name, list(args), cwd, timeout))
        if args[0] == "mdrun":
            with open(os.path.join(cwd, "topol.log"), "w") as fh:
                fh.write(GMX_LOG)
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(TT, "run_tool", run_tool)
    wd = str(tmp_path / "run")
    cfg = _configs(TCfg)[0]
    res = TG.run_gromacs_md(sys_t[0], cfg, 100, 0.002, wd, timeout=30)
    assert [c[1][0] for c in calls] == ["grompp", "mdrun"]
    assert calls[0][1][1:7] == ["-f", os.path.join(wd, "md.mdp"), "-c",
                                os.path.join(wd, "md.gro"), "-p",
                                os.path.join(wd, "md.top")]
    assert all(c[0] == "gromacs" and c[2] == wd and c[3] == 30
               for c in calls)
    assert res.energies == JG.parse_gromacs_log_energies(GMX_LOG)
    assert res.structure_path == os.path.join(wd, "topol.gro")
    assert abs(res.final_potential_kcal + 100.0) < 1e-12

    monkeypatch.setattr(TT, "run_tool", lambda *a, **k: SimpleNamespace(
        returncode=1, stdout="", stderr="grompp: fatal"))
    with pytest.raises(RuntimeError, match="grompp failed"):
        TG.run_gromacs_md(sys_t[0], cfg, 100, 0.002, wd)
    monkeypatch.setattr(JT, "run_tool", run_tool)
    with pytest.raises(TypeError):
        JG.run_gromacs_md(systems["ref"][1][0], _configs(JCfg)[0], 100,
                          0.002, str(tmp_path / "ref"))


# --------------------------------------------------------------------------
# ORCA

@pytest.mark.parametrize("task", sorted(JO.TASK_KEYWORDS))
def test_orca_input_matches_reference(task):
    e, x = WATER
    for kw in ({}, dict(n_procs=4, charge=-1, multiplicity=2,
                        extra_keywords=["TightSCF"], md_steps=50,
                        md_temp_k=310.0)):
        assert TO.make_input(e, x, TO.OrcaTask(task=task, **kw)) == \
            JO.make_input(e, x, JO.OrcaTask(task=task, **kw))
    with pytest.raises(ValueError):
        TO.make_input(e, x, TO.OrcaTask(task="freq"))


def test_orca_parsers_match_reference():
    assert TO.parse_final_energy(ORCA_OUT) == JO.parse_final_energy(ORCA_OUT)
    assert TO.parse_final_energy("nothing") is None
    (ej, pj), (et, pt) = JO.parse_optimized_geometry(ORCA_OUT), \
        TO.parse_optimized_geometry(ORCA_OUT)
    assert et == ej == ["O", "H", "H"]
    np.testing.assert_array_equal(pt, pj)
    assert TO.parse_optimized_geometry("nothing") is None
    np.testing.assert_array_equal(TO.parse_mbis_charges(MBIS_OUT),
                                  JO.parse_mbis_charges(MBIS_OUT))
    assert TO.parse_mbis_charges("nothing") is None
    fj, ft = JO.parse_xyz_trajectory(XYZ_TRAJ), TO.parse_xyz_trajectory(XYZ_TRAJ)
    assert len(ft) == len(fj) == 2
    for (a, x), (b, y) in zip(ft, fj):
        assert a == b
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("task", ["geometry_optimization", "mbis_charges",
                                  "mol_dynamics"])
def test_run_orca_with_the_binary_mocked(task, tmp_path, monkeypatch):
    """run_orca's input file, command and parsed result, with shutil.which
    and subprocess.run standing in for the orca binary; without a binary
    it raises."""
    import shutil

    e, x = WATER
    got = {}
    for tag, mod in (("ref", JO), ("port", TO)):
        wd = tmp_path / tag
        runs = _Runs(stdout=ORCA_OUT + MBIS_OUT)
        monkeypatch.setattr(shutil, "which", lambda exe: "/opt/orca/orca")
        monkeypatch.setattr(subprocess, "run", runs)
        wd.mkdir()
        (wd / "trajectory.xyz").write_text(XYZ_TRAJ)
        res = mod.run_orca(e, x, mod.OrcaTask(task=task), workdir=wd)
        cmd = runs.calls[0][0]
        got[tag] = (res, cmd[0], os.path.basename(cmd[1]),
                    (wd / "job.inp").read_text(), (wd / "job.out").read_text())
        monkeypatch.setattr(shutil, "which", lambda exe: None)
        with pytest.raises(RuntimeError, match="orca"):
            mod.run_orca(e, x, mod.OrcaTask(task=task), workdir=wd)
    (rt, *rest_t), (rj, *rest_j) = got["port"], got["ref"]
    assert rest_t == rest_j and rest_t[0] == "/opt/orca/orca"
    assert rt.keys() == rj.keys()
    for k in rt:
        if k == "workdir":
            continue
        a, b = rt[k], rj[k]
        if k == "geometry":
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        elif k == "trajectory":
            assert [f[0] for f in a] == [f[0] for f in b]
            for fa, fb in zip(a, b):
                np.testing.assert_array_equal(fa[1], fb[1])
        else:
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# hydrogen bonds

@pytest.fixture(scope="module")
def water_box():
    """Ethanol at the center of a 14 A box and the 3-site part of 80 OPC
    waters around it (positions from the port's fill), with each water's
    positions moved by up to 0.6 A so some cross the box faces."""
    mol = TS.from_smiles("CCO")
    box = np.array([14.0, 14.0, 14.0])
    x_lig = mol.positions - mol.positions.mean(0) + box / 2
    w = TW.fill_water_positions(box, exclude_positions=x_lig, n_target=80,
                                seed=4)[:, :3]
    rng = np.random.default_rng(9)
    w = w + rng.uniform(-0.6, 0.6, (len(w), 1, 3))
    elements = list(mol.elements) + ["O", "H", "H"] * len(w)
    n = mol.n_atoms
    bonds = list(mol.bonds) + [(n + 3 * k, n + 3 * k + h) for k in
                               range(len(w)) for h in (1, 2)]
    return elements, np.concatenate([x_lig, w.reshape(-1, 3)]), bonds, box


@pytest.mark.parametrize("with_box", [False, True])
def test_find_hydrogen_bonds_matches_reference(water_box, with_box):
    elements, x, bonds, box = water_box
    b = box if with_box else None
    for kw in ({}, dict(dist_cutoff=3.2, angle_cutoff_deg=135.0)):
        got = TH.find_hydrogen_bonds(elements, x, bonds, box=b, **kw)
        ref = JH.find_hydrogen_bonds(elements, x, bonds, box=b, **kw)
        assert [dataclasses.asdict(h) for h in got] == \
            [dataclasses.asdict(h) for h in ref]
        assert len(got) > 10
        assert all(h.distance <= kw.get("dist_cutoff", 3.5) for h in got)
    assert TH.find_hydrogen_bonds(["C", "H"], x[:2], [(0, 1)]) == []
