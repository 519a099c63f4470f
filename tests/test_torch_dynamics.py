"""Port parity of FastSim dynamics against molchanica_tpu's FastSim on the
CPU, and the port's table-overflow recovery.

8 steps at gamma = 0 (the Langevin noise is multiplied by zero, so the
two random streams do not matter) with a rebuild every 4 steps: two
rebuilds, and the r-RESPA reciprocal impulse of the hot periods.
Tolerance: positions within 5e-3 A after the 8 steps (float32 roundoff
grows along the trajectory; it starts at ~1e-6 A).
"""
import numpy as np
import pytest
import torch

from test_torch_fast_engine import make_pair, make_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stepped():
    js, ts = make_pair(gamma=0.0)
    js.step(0.002, 8)
    ts.step(0.002, 8)
    return js, ts


def test_trajectory_positions(stepped):
    js, ts = stepped
    n = js.top.n_atoms_real
    assert ts.step_count == js.step_count == 8
    d = np.abs(ts.positions_unsorted()[:n] - js.positions_unsorted()[:n])
    assert d.max() < 5e-3
    np.testing.assert_array_equal(ts.state.perm.numpy(),
                                  np.asarray(js.state.perm))


def test_trajectory_velocities_and_temperature(stepped):
    js, ts = stepped
    n = js.top.n_atoms_real
    vj = js.velocities_unsorted()[:n]
    vt = ts.velocities_unsorted()[:n]
    assert np.abs(vt - vj).max() < 5e-3 * np.abs(vj).max()
    assert abs(ts.temperature() - js.temperature()) < 1e-3 * \
        js.temperature()
    m = ts.metrics()
    assert m["steps"] == 8 and m["sim_ps"] == pytest.approx(0.016)


def test_overflow_replan_recovers():
    """A window table of 8 entries overflows; step() restores the last
    good state, doubles the table and carries on to the same answer."""
    ref = make_port(gamma=0.0)
    small = make_port(gamma=0.0)
    small._replan(per_slice_k=8)
    assert small._psk == 8
    ref.step(0.002, 4)
    small.step(0.002, 4)
    assert small._psk >= 32 and small.step_count == 4
    # one evaluation per step, plus one at each engine's init
    assert ref.force_evals == 1 + 4
    assert small.force_evals > 1 + 4
    assert int(small.state.overflow) == 0
    d = np.abs(small.positions_unsorted() - ref.positions_unsorted())
    assert d[:ref.top.n_atoms_real].max() < 1e-3
