"""Port parity: MdSim's FIRE relaxation (molchanica_tpu_torch.md.minimize,
one host loop) against the reference's fire_minimize_hostloop over the
200 iterations of MdConfig's default, on the cluster backend of
tests/test_torch_mdsim_default.py's system (the solvated 8-residue
polyalanine in a 24 A OPC box, 1,312 sites, 6 A cutoff), in float64.

The port places the M sites before every cluster rebuild; the reference's
FIRE never moves them (their dof_mask is 0), so its rebuild sorts them at
their starting positions. Fed the same placed rows, the reference's FIRE is
the port's: every evaluated energy within 1e-9 of |E| and the final
positions within 1e-8 A, once the reference's exclusion subtraction takes
its kernels' erfc slope (tests/jax_reference.py: the port leaves those
pairs out, the reference adds and subtracts them). On that shared trace
FIRE climbs once it has passed its lowest state: it falls from E0 = 2,360
to -1,256 kcal/mol at iteration 60 and ends near -577 (the velocity keeps
the components that the 0.1 A clamp and the constraint projection take out
of the move). The reference as it runs, with stale M rows, leaves that
trace after its lowest state and climbs further.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molchanica_tpu.md.config import MdConfig as JCfg
from molchanica_tpu.md.energy import apply_virtual_sites as j_place
from molchanica_tpu.md.engine import MdSim as JMd
from molchanica_tpu.md.minimize import fire_minimize_hostloop
from molchanica_tpu.systems.bench_systems import build_solvated_protein
from molchanica_tpu_torch.md.config import MdConfig
from molchanica_tpu_torch.md.engine import MdSim
from molchanica_tpu_torch.md.minimize import fire_minimize
from molchanica_tpu_torch.topology import (STATIC_FIELDS, TENSOR_FIELDS,
                                           topology_from_numpy)
from jax_reference import kernel_slope

torch.set_num_threads(1)

N_ITERS = 200
KW = dict(lj_cutoff=6.0, coulomb_cutoff=6.0, max_init_relaxation_iters=None,
          seed=3, dtype="float64")


@pytest.fixture(scope="module")
def traces():
    """Energies per FIRE iteration and the final positions: the port, the
    reference fed placed M rows, and the reference as it runs."""
    asys = build_solvated_protein(n_residues=8, box_side=24.0, seed=3)
    jt = asys.topology
    fields = {f: np.asarray(getattr(jt, f)) for f in TENSOR_FIELDS}
    jt = jt.replace(**{f: jnp.asarray(a, jnp.float64)
                       for f, a in fields.items()
                       if np.issubdtype(a.dtype, np.floating)})
    tt = topology_from_numpy(fields, {s: getattr(asys.topology, s)
                                      for s in STATIC_FIELDS},
                             dtype=torch.float64)
    x0 = np.asarray(asys.positions, np.float64)
    js = JMd(jt, JCfg(use_scan_chunks=False, **KW), x0,
             box_extent=asys.box_extent, method="cells_pme", relax=False)
    ts = MdSim(tt, MdConfig(**KW), x0, box_extent=asys.box_extent,
               method="cells_pme", relax=False, device="cpu")
    assert js._nbr_backend == ts._nbr_backend == "clusters"
    out = {}
    s = js.state
    for tag, place in (("placed", True), ("as_it_runs", False)):
        rec = []

        def force(x, box, couple, place=place, rec=rec):
            f, (e, terms) = js.force_fn(j_place(x, js.top) if place else x,
                                        box, couple)
            jax.debug.callback(lambda v: rec.append(float(v)), e)
            return f, (e, terms)

        with kernel_slope():
            x, _ = fire_minimize_hostloop(
                force, s.positions, s.box, s.couple, js.top.dof_mask,
                n_steps=N_ITERS, constrain_positions=js._cp)
            jax.effects_barrier()
        out[tag] = (np.array(rec), np.asarray(x))
    energies = []
    with torch.no_grad():
        x, _ = fire_minimize(ts.force_fn, ts.state.positions, ts.state.box,
                             ts.state.couple, ts.top.dof_mask,
                             n_steps=N_ITERS, constrain_positions=ts._cp,
                             energies=energies)
    out["port"] = (np.array([float(e) for e in energies]), x.numpy())
    return out


def test_fire_matches_the_reference_fed_placed_sites(traces):
    e_t, x_t = traces["port"]
    e_j, x_j = traces["placed"]
    assert len(e_t) == len(e_j) == N_ITERS
    np.testing.assert_allclose(e_t, e_j, rtol=1e-9, atol=0)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-8)


def test_fire_climbs_like_the_reference(traces):
    """Reference and port alike: FIRE descends by more than MdSim's check
    margin max(1% |E0|, 10), then ends more than that margin above its
    lowest state."""
    for tag in ("port", "placed", "as_it_runs"):
        e = traces[tag][0]
        i = int(np.argmin(e))
        margin = max(0.01 * abs(e[0]), 10.0)
        print(f"{tag}: E0 {e[0]:.4f}, lowest {e[i]:.4f} at iteration {i}, "
              f"last {e[-1]:.4f} kcal/mol")
        assert e[i] < e[0] - margin, tag
        assert 0 < i < N_ITERS - 1 and e[-1] > e[i] + margin, tag
    # the reference as it runs matches the port until its stale M rows
    # cost it pairs, then climbs further
    e_t, e_r = traces["port"][0], traces["as_it_runs"][0]
    np.testing.assert_allclose(e_r[:50], e_t[:50], rtol=1e-9, atol=0)
    assert e_r[-1] > e_t[-1] + abs(e_t[-1])
