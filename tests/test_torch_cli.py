"""Port parity: the headless CLI (molchanica_tpu_torch.cli, tasks,
__main__) against molchanica_tpu.cli on the CPU.

Every case of the JAX package's tests/test_cli.py has its counterpart
here, run on a CliState(device="cpu") with the JAX package's output
beside it. Tolerances: `show`, `select`, `remove`, `characterize`,
`fetch glucose`, `help` and the saved SDF equal as text; `energy`'s terms
(float64) within 1e-9 relative and `minimize 20`'s positions within 1e-8
A (tests/test_torch_fire.py's FIRE tolerance), both against the JAX
CLI's code path on its topology cast to float64 (the JAX CLI itself
forms float32 products of its float32 parameters, so its printed values
are held to their last printed digit); `predict caco2_wang CCO` within
the 4.370e-6 that the therapeutic tests hold raw outputs to
(lipophilicity_astrazeneca is never read: tests/test_therapeutic.py
rewrites its weights during the run). Sessions saved by either package
load in the other.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from molchanica_tpu import cli as J
from molchanica_tpu_torch import cli as T
from molchanica_tpu_torch.tasks import TaskError, TaskRegistry
from test_torch_user_layer import _jax_float64

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREDICT_TOL = 4.370e-6


def _pair(cmd="load smiles:CC(=O)O"):
    js, ts = J.CliState(), T.CliState(device="cpu")
    assert J.handle_cmd(js, cmd) == T.handle_cmd(ts, cmd)
    return js, ts


def _both(pair, cmd):
    js, ts = pair
    return J.handle_cmd(js, cmd), T.handle_cmd(ts, cmd)


def test_help_equal():
    assert T.HELP == J.HELP
    st = T.CliState(device="cpu")
    assert T.handle_cmd(st, "help") == J.HELP


def test_load_show():
    p = _pair()
    a, b = _both(p, "show")
    assert a == b and "atoms" in b


def test_select_and_remove():
    p = _pair()
    for cmd in ("select elem O", "select resn UNL", "select elem C"):
        a, b = _both(p, cmd)
        assert a == b, cmd
    a, b = _both(p, "select elem O")
    assert "2 atoms" in b
    n0 = p[1].active_mol().n_atoms
    a, b = _both(p, "remove sel")
    assert a == b
    assert p[1].active_mol().n_atoms == n0 - 2
    np.testing.assert_array_equal(np.asarray(p[0].active_mol().positions),
                                  p[1].active_mol().positions)
    assert p[0].active_mol().bonds == p[1].active_mol().bonds


def test_save_load_roundtrip(tmp_path):
    js, ts = _pair()
    pj, pt = str(tmp_path / "j.sdf"), str(tmp_path / "t.sdf")
    J.handle_cmd(js, f"save {pj}")
    T.handle_cmd(ts, f"save {pt}")
    assert open(pj).read() == open(pt).read()
    st2 = T.CliState(device="cpu")
    out = T.handle_cmd(st2, f"load {pt}")
    assert "atoms" in out
    assert st2.active_mol().n_atoms == ts.active_mol().n_atoms


def test_characterize():
    a, b = _both(_pair(), "characterize")
    assert a == b and "cLogP" in b and "TPSA" in b


def test_energy_and_minimize():
    """`energy` and `minimize 20` against the JAX CLI's own code path
    (its _to_spec, assemble_system, MdConfig) on the float64 topology."""
    from molchanica_tpu.md.config import Integrator as JInt
    from molchanica_tpu.md.config import MdConfig as JCfg
    from molchanica_tpu.md.engine import MdSim as JMd
    from molchanica_tpu.md.engine import compute_energy_snapshot as j_snap
    from molchanica_tpu.molecules.spec import assemble_system as j_asm

    p = _pair()
    js, ts = p
    asys = j_asm([J._to_spec(js.active_mol())])
    top = _jax_float64(asys.topology)
    ref = j_snap(top, JCfg(integrator=JInt.verlet_velocity(),
                           dtype="float64", max_init_relaxation_iters=None),
                 asys.positions)
    got = T.energy_terms(ts)
    assert list(got) == [k for k in T.ENERGY_TERMS if k in ref]
    for k, v in got.items():
        assert abs(v - ref[k]) <= 1e-9 * max(abs(ref[k]), 1e-12), k
    a, b = _both(p, "energy")
    assert "energy_potential" in b
    for la, lb in zip(a.split("\n"), b.split("\n")):
        assert la.split(":")[0] == lb.split(":")[0]
        assert abs(float(la.split()[1]) - float(lb.split()[1])) <= 1.5e-4
    n0 = js.active_mol().n_atoms
    jm = JMd(top, JCfg(integrator=JInt.verlet_velocity(), dtype="float64",
                       max_init_relaxation_iters=20), asys.positions)
    out = T.handle_cmd(ts, "minimize 20")
    assert out.startswith("minimized 20 iters; E = ")
    e_j = float(jm.state.pe_last)
    assert abs(float(out.split("E =")[1]) - e_j) <= 5e-5 + 1e-9 * abs(e_j)
    np.testing.assert_allclose(ts.active_mol().positions,
                               np.asarray(jm.state.positions)[:n0],
                               rtol=0, atol=1e-8)
    assert J.handle_cmd(js, "minimize 20").startswith(
        "minimized 20 iters; E = ")


def test_session_roundtrip_across_packages(tmp_path):
    p = _pair()
    _both(p, "select elem C")
    for tag, (js, ts) in (("j", p), ("t", p)):
        path = str(tmp_path / f"{tag}.json")
        src = J if tag == "j" else T
        src.handle_cmd(js if tag == "j" else ts, f"session save {path}")
        for dst, st2 in ((J, J.CliState()), (T, T.CliState(device="cpu"))):
            out = dst.handle_cmd(st2, f"session load {path}")
            assert "1 molecules" in out
            assert st2.active_mol().n_atoms == ts.active_mol().n_atoms
            np.testing.assert_array_equal(
                np.asarray(st2.active_mol().positions),
                ts.active_mol().positions)
    blobs = [json.load(open(tmp_path / f"{tag}.json")) for tag in "jt"]
    for b in blobs:
        b["history"] = b["history"][:-1]      # the save command's own path
    assert blobs[0] == blobs[1]


def test_errors():
    for mod, st in ((J, J.CliState()), (T, T.CliState(device="cpu"))):
        with pytest.raises(mod.CliError, match="no molecule loaded"):
            mod.handle_cmd(st, "energy")            # nothing loaded
        with pytest.raises(mod.CliError, match="not in the embedded"):
            mod.handle_cmd(st, "fetch 1abc")        # offline
        with pytest.raises(mod.CliError, match="unrecognized"):
            mod.handle_cmd(st, "frobnicate")        # unknown


def test_predict_via_cli(monkeypatch):
    from molchanica_tpu.therapeutic import TherapeuticPredictor as JP
    from molchanica_tpu_torch.therapeutic import TherapeuticPredictor as TP
    raw, predict = [], JP.predict

    def recorded(self, smiles):
        out = predict(self, smiles)
        raw.append((self.target, list(smiles), np.asarray(out)))
        return out

    # the JAX CLI's raw output, recorded as its predictor returns it
    monkeypatch.setattr(JP, "predict", recorded)
    a, b = _both((J.CliState(), T.CliState(device="cpu")),
                 "predict caco2_wang CCO")
    assert b.startswith("caco2_wang(CCO) = ")
    assert [r[:2] for r in raw] == [("caco2_wang", ["CCO"])]
    ref = float(raw[0][2][0])
    got = float(TP("caco2_wang", device="cpu").predict(["CCO"])[0])
    assert abs(got - ref) <= PREDICT_TOL * (1.0 + abs(ref))
    assert abs(float(b.split("=")[1]) - ref) <= 5e-5 + PREDICT_TOL


def test_targets_listing():
    a, b = _both((J.CliState(), T.CliState(device="cpu")), "targets")
    assert "caco2_wang" in b.split("\n")
    assert set(a.split("\n")) <= set(b.split("\n"))


def test_main_batch_exit_codes(capsys):
    assert T.main(["load smiles:CCO", "show"], device="cpu") == 0
    assert "atoms" in capsys.readouterr().out
    assert T.main(["show"], device="cpu") == 1
    assert "no molecule loaded" in capsys.readouterr().err
    # a non-CLI failure propagates, so a device fault exits non-zero
    with pytest.raises(ValueError, match="PNG only"):
        T.main(["load smiles:CCO", "png out.svg"], device="cpu")


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["load smiles:CCO", "energy"])


def test_module_runs_help_with_stdin_closed():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "molchanica_tpu_torch",
                        "help"], cwd=ROOT, env=env, capture_output=True,
                       text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == J.HELP + "\n"


def test_fetch_from_embedded_db():
    js, ts = J.CliState(), T.CliState(device="cpu")
    a, b = J.handle_cmd(js, "fetch glucose"), T.handle_cmd(ts, "fetch glucose")
    assert a == b and "glucose" in b and "24 atoms" in b
    assert ts.active == "glucose"
    x = np.asarray(ts.mols["glucose"].positions)
    np.testing.assert_array_equal(x, np.asarray(js.mols["glucose"].positions))
    assert np.ptp(x, axis=0).min() > 0.5
    with pytest.raises(T.CliError, match="not in the embedded databases"):
        T.handle_cmd(ts, "fetch definitely-not-a-molecule")


def test_task_registry_basic():
    """submit / poll exactly once / join, and error surfacing (reference
    ThreadReceivers contract, src/threads.rs:32-77)."""
    reg = TaskRegistry()
    h1 = reg.submit("ok", lambda: 41 + 1)
    h2 = reg.submit("boom", lambda: 1 / 0)
    assert h1.join(10.0) == 42
    with pytest.raises(TaskError, match="division"):
        h2.join(10.0)
    time.sleep(0.05)
    drained = dict(reg.poll())
    assert set(drained) == {h1.name, h2.name}
    assert reg.poll() == []          # exactly-once delivery
    assert reg.running() == []
    with pytest.raises(TaskError, match="cuda:<index>"):
        reg.submit("x", lambda: 0, cuda_device="cpu").join(10.0)


def test_cli_bg_md_roundtrip():
    """bg md runs in the background; wait collects the result and merges
    the moved molecule back into the live session."""
    from molchanica_tpu_torch.molecules.embed import embed_3d
    from molchanica_tpu_torch.molecules.smiles import from_smiles

    st = T.CliState(device="cpu")
    mol = from_smiles("CO")
    embed_3d(mol)
    st.mols["meoh"] = mol
    st.active = "meoh"
    x0 = np.asarray(mol.positions).copy()
    out = T.handle_cmd(st, "bg md 20 0.0005")
    assert "launched task" in out
    name = out.split("'")[1]
    assert st.tasks.get(name).kind == "md"
    out = T.handle_cmd(st, f"wait {name}")
    assert "done in" in out and "T =" in out
    assert not np.allclose(np.asarray(st.mols["meoh"].positions), x0)
    assert T.handle_cmd(st, "tasks") == "(no tasks)"
