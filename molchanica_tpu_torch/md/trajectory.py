"""Trajectory: unified access to in-memory snapshots and DCD/GRO files.

Copy of molchanica_tpu.md.trajectory: host-side numpy over snapshots
that are already on the host, so its results equal the reference's. As
there, a .gro opens for its frame count only and `load_snaps` refuses
it; io.gro.read_gro_trajectory reads a multi-frame .gro's frames.

Reference: `Trajectory` over TRR/XTC/DCD/in-memory (src/md/trajectory.rs:
29-86), metadata-only open (:91), `load_snaps` with FrameSlice index/time
windows (:208).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .snapshot import Snapshot


@dataclass
class FrameSlice:
    """Index/time frame selection (reference FrameSlice)."""
    start: Optional[int] = None
    stop: Optional[int] = None
    step: int = 1
    t_start: Optional[float] = None   # ps
    t_stop: Optional[float] = None

    def select(self, times: np.ndarray) -> np.ndarray:
        idx = np.arange(len(times))
        if self.t_start is not None:
            idx = idx[times[idx] >= self.t_start]
        if self.t_stop is not None:
            idx = idx[times[idx] <= self.t_stop]
        return idx[self.start:self.stop:self.step]


class Trajectory:
    """In-memory or file-backed trajectory of Snapshots."""

    def __init__(self, snapshots: Optional[List[Snapshot]] = None,
                 path: Optional[str] = None, dt_ps: float = 0.002,
                 save_interval: int = 1):
        self.snapshots: List[Snapshot] = list(snapshots or [])
        self.path = path
        self._dt = dt_ps
        self._interval = save_interval
        self._file_meta = None
        if path is not None:
            self._open_metadata(path)

    # ---- reference surface ----
    @staticmethod
    def from_memory(snapshots: Sequence[Snapshot]) -> "Trajectory":
        return Trajectory(snapshots=list(snapshots))

    @staticmethod
    def open(path, dt_ps: float = 0.002) -> "Trajectory":
        """Metadata-only open (reference :91); frames load lazily."""
        return Trajectory(path=str(path), dt_ps=dt_ps)

    def _open_metadata(self, path):
        p = str(path).lower()
        if p.endswith(".dcd"):
            from ..io.dcd import read_dcd
            frames, cells = read_dcd(path)
            self._file_meta = ("dcd", frames, cells)
        elif p.endswith(".trr"):
            from ..io.trr import read_trr
            trr = read_trr(path)
            frames = [f.positions for f in trr]
            cells = [f.box_extent for f in trr]
            self._trr_times = np.asarray([f.time_ps for f in trr])
            self._file_meta = ("trr", frames, cells)
        elif p.endswith(".xtc"):
            from ..io.xtc import read_xtc
            xtc = read_xtc(path)
            frames = [f.positions for f in xtc]
            cells = [f.box_extent for f in xtc]
            self._trr_times = np.asarray([f.time_ps for f in xtc])
            self._file_meta = ("xtc", frames, cells)
        elif p.endswith(".gro"):
            self._file_meta = ("gro", None, None)
        else:
            raise ValueError(f"unsupported trajectory format: {path}")

    @property
    def n_frames(self) -> int:
        if self.snapshots:
            return len(self.snapshots)
        if self._file_meta and self._file_meta[0] in ("dcd", "trr",
                                                     "xtc"):
            return len(self._file_meta[1])
        if self._file_meta and self._file_meta[0] == "gro":
            return sum(1 for line in open(self.path)
                       if line.startswith("frame "))
        return 0

    def times(self) -> np.ndarray:
        if self.snapshots:
            return np.asarray([s.time for s in self.snapshots])
        if getattr(self, "_trr_times", None) is not None:
            return self._trr_times
        return np.arange(self.n_frames) * self._dt * self._interval

    def load_snaps(self, frame_slice: Optional[FrameSlice] = None
                   ) -> List[Snapshot]:
        """Load snapshots, optionally windowed (reference load_snaps :208)."""
        fs = frame_slice or FrameSlice()
        if self.snapshots:
            idx = fs.select(self.times())
            return [self.snapshots[i] for i in idx]
        if self._file_meta and self._file_meta[0] in ("dcd", "trr",
                                                     "xtc"):
            _, frames, cells = self._file_meta
            times = self.times()
            idx = fs.select(times)
            out = []
            for i in idx:
                out.append(Snapshot(
                    time=float(times[i]), atom_posits=frames[i],
                    box_extent=None if cells is None else cells[i]))
            return out
        raise ValueError("no frames available")

    # ---- writers ----
    def save_dcd(self, path, box_extent=None):
        from ..io.dcd import write_dcd
        frames = np.stack([self._frame_coords(s) for s in self.snapshots])
        box = box_extent
        if box is None and self.snapshots and \
                self.snapshots[0].box_extent is not None:
            box = self.snapshots[0].box_extent
        write_dcd(path, frames, box_extent=box, dt_ps=self._dt,
                  save_interval=self._interval)
        return path

    def save_trr(self, path, box_extent=None):
        """GROMACS TRR (so reference-side tooling can play our output)."""
        from ..io.trr import TrrFrame, write_trr
        frames = []
        for s in self.snapshots:
            box = s.box_extent if s.box_extent is not None else box_extent
            frames.append(TrrFrame(
                step=int(round(s.time / max(self._dt, 1e-12))),
                time_ps=float(s.time), box_extent=box,
                positions=self._frame_coords(s), velocities=None))
        write_trr(frames, path)
        return path

    def save_xtc(self, path, box_extent=None, precision: float = 1000.0):
        """GROMACS XTC compressed trajectory (reference trajectory.rs XTC
        branch)."""
        from ..io.xtc import XtcFrame, write_xtc
        frames = []
        for s in self.snapshots:
            box = s.box_extent if s.box_extent is not None else box_extent
            frames.append(XtcFrame(
                step=int(round(s.time / max(self._dt, 1e-12))),
                time_ps=float(s.time), box_extent=box,
                positions=self._frame_coords(s)))
        write_xtc(frames, path, precision=precision)
        return path

    def save_gro(self, path, elements, box_extent=None):
        """Reference MD auto-save format (./md_out/traj_N.gro)."""
        from ..io.gro import write_gro_trajectory
        frames = [self._frame_coords(s) for s in self.snapshots]
        box = box_extent
        if box is None and self.snapshots and \
                self.snapshots[0].box_extent is not None:
            box = self.snapshots[0].box_extent
        write_gro_trajectory(path, elements, frames,
                             box_extent=box if box is not None else
                             np.zeros(3))
        return path

    @staticmethod
    def _frame_coords(s: Snapshot) -> np.ndarray:
        parts = [s.atom_posits]
        if s.water_o_posits is not None:
            w = np.stack([s.water_o_posits, s.water_h0_posits,
                          s.water_h1_posits], axis=1).reshape(-1, 3)
            parts.append(w)
        return np.concatenate(parts, axis=0)
