"""Port parity of the block-pair accumulation probe (P): the port's
`probe_plain` (molchanica_tpu_torch.ops.probe_prefetch) against a
pallas_call of scripts/probe_prefetch.py's own `kernel`, loaded by path,
with the script's scalar-prefetch grid spec in interpret mode on the CPU.

Tolerance: max |difference| over max |reference| < 1e-6 for o and o2, the
script's own bound (float32 summation order only). Cases: the script's
inputs (NC = 16, W = 8, S = 1,024, default_rng(0)), clusters with no
entry, slices repeated within and across clusters, and a j array wider
than the rows (S = 2,048 for 8 clusters).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from molchanica_tpu_torch import tracing
from molchanica_tpu_torch.ops import probe_prefetch as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ICL, LAN = 64, 128


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "probe_prefetch_script",
        os.path.join(ROOT, "scripts", "probe_prefetch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(script, nw, sl, rows, pT):
    """The script's pallas_call at these shapes, in interpret mode."""
    NC, W = sl.shape
    S = pT.shape[1]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2,
        grid=(NC, W),
        in_specs=[
            pl.BlockSpec((ICL, 8), lambda ci, w, nw_r, sl_r: (ci, 0)),
            pl.BlockSpec((8, LAN),
                         lambda ci, w, nw_r, sl_r: (0, sl_r[ci, w])),
        ],
        out_specs=[
            pl.BlockSpec((ICL, 8), lambda ci, w, nw_r, sl_r: (ci, 0)),
            pl.BlockSpec((8, S), lambda ci, w, nw_r, sl_r: (0, 0)),
        ],
    )
    fn = pl.pallas_call(
        script.kernel, grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((NC * ICL, 8), jnp.float32),
                   jax.ShapeDtypeStruct((8, S), jnp.float32)],
        interpret=True)
    o, o2 = fn(*(jnp.asarray(a) for a in (nw, sl, rows, pT)))
    return np.asarray(o), np.asarray(o2)


def _case(name):
    if name == "script":
        return P.probe_inputs()
    if name == "empty_clusters":
        nw, sl, rows, pT = P.probe_inputs(seed=1)
        nw[[0, 5, 15]] = 0
        return nw, sl, rows, pT
    if name == "repeated_slices":
        nw, sl, rows, pT = P.probe_inputs(seed=2)
        nw[:] = 8
        sl[:, 1::2] = sl[:, ::2]            # each slice twice per cluster
        sl[3] = sl[4]                       # and across clusters
        return nw, sl, rows, pT
    return P.probe_inputs(NC=8, W=6, S=2048, seed=3)


CASES = ["script", "empty_clusters", "repeated_slices", "wide_j"]


@pytest.mark.parametrize("name", CASES)
def test_probe_plain_matches_pallas(script, name):
    nw, sl, rows, pT = _case(name)
    o_ref, o2_ref = _pallas(script, nw, sl, rows, pT)
    o, o2 = P.probe(*(torch.as_tensor(a) for a in (nw, sl, rows, pT)))
    e1, e2 = P.rel_errors(o.numpy(), o2.numpy(), o_ref, o2_ref)
    assert e1 < 1e-6 and e2 < 1e-6, (e1, e2)
    # columns 1-7 of o and rows 1-7 of o2 stay zero; clusters without an
    # entry have zero rows
    assert float(o[:, 1:].abs().max()) == 0.0
    assert float(o2[1:].abs().max()) == 0.0
    empty = np.repeat(nw == 0, ICL)
    assert empty.any() == (name == "empty_clusters")
    assert float(o[torch.as_tensor(empty)].abs().sum()) == 0.0
    assert o_ref[empty].sum() == 0.0
    # CPU tensors take the plain path
    assert tracing.counters("probe_prefetch") == {}


@pytest.mark.parametrize("name", CASES)
def test_probe_plain_matches_loop(name):
    nw, sl, rows, pT = _case(name)
    o, o2 = P.probe_plain(*(torch.as_tensor(a) for a in (nw, sl, rows, pT)))
    e1, e2 = P.rel_errors(o.numpy(), o2.numpy(),
                          *P.probe_loop(nw, sl, rows, pT))
    assert e1 < 1e-6 and e2 < 1e-6, (e1, e2)


def test_probe_main_on_cpu(capsys):
    assert P.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "PROBE OK" and "rel_err o=" in out[-2]
