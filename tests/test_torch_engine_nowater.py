"""Port parity of FastSim without water against molchanica_tpu's FastSim
on the CPU: no species split, so the direct sum is the one triangular
'full' colpair kernel on the master window tables.

Tolerances as in test_torch_fast_engine.py: master tables exactly equal;
init force within 1e-4 of the largest force plus 2e-6 of the largest
direct-space kernel force; positions within 5e-3 A after four steps.
"""
import numpy as np
import torch

from molchanica_tpu.md.config import HydrogenConstraint as JH
from molchanica_tpu.md.config import Integrator as JInt
from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.fast_engine import FastSim as JFast
from molchanica_tpu.molecules.spec import assemble_system as j_assemble
from molchanica_tpu.systems.bench_systems import build_polyalanine
from molchanica_tpu_torch.md.config import (HydrogenConstraint, Integrator,
                                            MdConfig)
from molchanica_tpu_torch.md.fast_engine import FastSim
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)
from test_torch_fast_engine import KW, _eq

torch.set_num_threads(1)


def test_monolithic_path_without_water():
    """No water, so no species split: the direct sum is the one triangular
    'full' kernel on the master tables. Init force against the reference,
    then four steps of each engine at gamma = 0."""
    pep = build_polyalanine(8, seed=3)
    box = np.array([24.0, 24.0, 24.0])
    pep = pep.translated(box / 2.0 - pep.positions.mean(axis=0))
    asys = j_assemble([pep], box_extent=box, seed=3)
    jt = asys.topology
    rng = np.random.default_rng(1)
    v0 = (rng.normal(size=(jt.n_atoms, 3)) * np.asarray(jt.dof_mask)[:, None]
          ).astype(np.float32)
    kw = dict(KW, neighbor_rebuild_every=2)
    js = JFast(jt, JCfg(integrator=JInt.langevin_middle(gamma=0.0),
                        hydrogen_constraint=JH.shake(), **kw),
               asys.positions, box_extent=box, velocities=v0)
    tt = topology_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS},
        {s: getattr(jt, s) for s in STATIC_FIELDS})
    ts = FastSim(tt, MdConfig(
        integrator=Integrator.langevin_middle(gamma=0.0),
        hydrogen_constraint=HydrogenConstraint.shake(), **kw),
        asys.positions, box_extent=box, velocities=v0, device="cpu")
    assert ts._split is None and ts.state.wl is not None
    _eq(js.state.wl, ts.state.wl, "wl")
    _eq(js.state.nw, ts.state.nw, "nw")
    fj = np.asarray(js.state.f, np.float32)
    with torch.no_grad():
        st = ts.state
        rows = torch.cat([st.x, st.props], 1)
        f_dir = ts._direct[False](rows, rows.T.contiguous(), st.wl, st.nw,
                                  st.box, st.couple)[0]
    err = np.abs(ts.state.f.numpy() - fj).max()
    assert err <= 1e-4 * np.abs(fj).max() + 2e-6 * float(f_dir.abs().max())
    js.step(0.001, 4)
    ts.step(0.001, 4)
    n = jt.n_atoms_real
    d = np.abs(ts.positions_unsorted()[:n] - js.positions_unsorted()[:n])
    assert d.max() < 5e-3
