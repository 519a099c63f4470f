"""`correct` on the CPU at a tiny size: a sound run passes, and a run with
the timed path broken underneath fails, once for each fault a replica farm
can have (it has no exchange between chips). The harness's look for a card
is skipped: the cell runs on the CPU through harness.Run."""
import contextlib

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import planted
from benchmark.tests.tiny import make_root
from molchanica_tpu_torch.parallel import replicas


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def run_cell(tiny, seed=11, fault=None):
    """A run of the tiny cell; `fault` (one of calibrate.py's) is planted
    for the checked steps."""
    root, bench = tiny
    run = harness.Run(root, "tiny.cell", seed, "cpu", bench)
    run.setup()
    run.window(0.5)
    with (planted(fault, run.farm) if fault else contextlib.nullcontext()):
        ok, failed, rows, nums, _ = run.check()
    return ok, failed, nums


def test_sound_run_is_correct(tiny):
    ok, failed, nums = run_cell(tiny)
    assert ok and failed == 0, nums


def test_state_left_unchanged_fails(tiny, monkeypatch):
    step = replicas._Chunk.step

    def frozen(self, dt, noise, record_dhdl):
        x, v = self.x, self.v
        out = step(self, dt, noise, record_dhdl)
        self.x, self.v = x, v
        return out

    monkeypatch.setattr(replicas._Chunk, "step", frozen)
    ok, failed, nums = run_cell(tiny)
    assert not ok and failed == 2, nums


def test_half_of_the_replicas_left_out_fails(tiny, monkeypatch):
    step = replicas._Chunk.step

    def half(self, dt, noise, record_dhdl):
        x, v = self.x, self.v
        out = step(self, dt, noise, record_dhdl)
        h = x.shape[0] // 2
        self.x = torch.cat([self.x[:h], x[h:]])
        self.v = torch.cat([self.v[:h], v[h:]])
        return out

    monkeypatch.setattr(replicas._Chunk, "step", half)
    ok, failed, nums = run_cell(tiny)
    assert not ok and failed == 1, nums


def test_force_altered_where_produced_fails(tiny, monkeypatch):
    force = replicas._Batched._force_cells

    def altered(self, x, box, c, nbr):
        f, rest = force(self, x, box, c, nbr)
        f = f.clone()
        f[0] = f[0] * 1.001      # replica 0's answer, off by 0.1%
        return f, rest

    monkeypatch.setattr(replicas._Batched, "_force_cells", altered)
    ok, failed, nums = run_cell(tiny)
    assert not ok and failed == 1, nums


def test_bonded_terms_left_out_fails(tiny):
    ok, failed, nums = run_cell(tiny, fault="bonded_off")
    assert not ok and failed == 2, nums
    assert nums["force_median_solute"] > 0.1, nums


def test_constraints_left_out_fails(tiny):
    ok, failed, nums = run_cell(tiny, fault="constraints_off")
    assert not ok and failed == 2, nums
    assert nums["constraint_error"] > 1e-2, nums
