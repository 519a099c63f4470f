"""High-level run entry points with the reference's names (port of part of
molchanica_tpu.md.dynamics): `run_dynamics_blocking`, `MdHandle` and
`launch_md`. `build_dynamics`, `MolDynamics` and `add_copies` need the
force-field typing and the SMILES stack, which the port does not have yet
(ROADMAP Queue 1, item 12).
"""
from __future__ import annotations

import threading
from typing import Optional

from .engine import MdSim


def run_dynamics_blocking(sim: MdSim, dt_ps: float, n_steps: int,
                          snapshot_interval: Optional[int] = None):
    """Run n_steps and return the snapshot list (reference
    run_dynamics_blocking)."""
    return sim.run(dt_ps, n_steps, snapshot_interval=snapshot_interval)


class MdHandle:
    """A run in a background thread (reference launch_md's handle): poll
    `running` and `step_count`, or `join` for the snapshots; an error in
    the run is raised by `join`."""

    def __init__(self, sim: MdSim, dt_ps: float, n_steps: int,
                 snapshot_interval: Optional[int]):
        self.sim = sim
        self._err: Optional[BaseException] = None
        self._done = threading.Event()

        def work():
            try:
                sim.run(dt_ps, n_steps, snapshot_interval=snapshot_interval)
            except BaseException as e:   # surfaced on join()
                self._err = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    @property
    def running(self) -> bool:
        return not self._done.is_set()

    @property
    def step_count(self) -> int:
        return self.sim.step_count

    def join(self, timeout=None):
        self._thread.join(timeout)
        if self._err is not None:
            raise self._err
        return self.sim.snapshots


def launch_md(sim: MdSim, dt_ps: float, n_steps: int,
              snapshot_interval: Optional[int] = None) -> MdHandle:
    """Start a non-blocking run (reference launch_md)."""
    return MdHandle(sim, dt_ps, n_steps, snapshot_interval)
