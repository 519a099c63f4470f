"""SnapshotViewer: headless playback/indexing model over snapshots.

Copy of molchanica_tpu.md.viewer: host-side numpy over snapshots
that are already on the host, so its results equal the reference's.

Reference surface: SnapshotViewer (src/md/viewer.rs:227-308)
— snapshots list, current index, playback ratio (snapshots advanced per
real second), play/pause, change_snapshot, plus trajectory-file loading.
The rendering half of the reference viewer is UI; this headless model keeps
the state machine and file plumbing so downstream tooling (or the Rust
viewer via TRR/DCD export) can drive playback.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .snapshot import Snapshot
from .trajectory import FrameSlice, Trajectory


@dataclass
class SnapshotViewer:
    snapshots: List[Snapshot] = field(default_factory=list)
    current_snapshot: Optional[int] = None
    playback_ratio: float = 20.0      # snapshots per real second
    playing: bool = False
    playback_accum: float = 0.0       # seconds since last advance

    # ---- reference surface ----
    def get_active_snap(self) -> Optional[Snapshot]:
        if self.current_snapshot is None:
            return None
        return self.get_snap(self.current_snapshot)

    def get_snap(self, i: int) -> Optional[Snapshot]:
        if 0 <= i < len(self.snapshots):
            return self.snapshots[i]
        return None

    def change_snapshot(self, snap_i: int) -> Snapshot:
        if not (0 <= snap_i < len(self.snapshots)):
            raise IndexError(
                f"snapshot {snap_i} out of range 0..{len(self.snapshots)}")
        self.current_snapshot = snap_i
        return self.snapshots[snap_i]

    # ---- playback state machine ----
    def play(self):
        self.playing = True
        self.playback_accum = 0.0

    def pause(self):
        self.playing = False

    def tick(self, dt_wall_s: float) -> Optional[int]:
        """Advance playback by dt_wall seconds; returns the new index if
        the frame changed. Wraps at the end (loop playback)."""
        if not self.playing or not self.snapshots:
            return None
        self.playback_accum += dt_wall_s
        period = 1.0 / max(self.playback_ratio, 1e-9)
        advanced = int(self.playback_accum / period)
        if advanced == 0:
            return None
        self.playback_accum -= advanced * period
        cur = self.current_snapshot or 0
        self.current_snapshot = (cur + advanced) % len(self.snapshots)
        return self.current_snapshot

    # ---- loading ----
    def load_snapshots(self, snaps: List[Snapshot], reset: bool = True):
        self.snapshots = list(snaps)
        if reset or self.current_snapshot is None:
            self.current_snapshot = 0 if self.snapshots else None

    def load_trajectory(self, path, frame_slice: Optional[FrameSlice] = None,
                        dt_ps: float = 0.002):
        """Load DCD/TRR/GRO frames (reference load_gro / trajectory open)."""
        traj = Trajectory.open(path, dt_ps=dt_ps)
        self.load_snapshots(traj.load_snaps(frame_slice))
        return self

    def frame_at_time(self, t_ps: float) -> int:
        """Nearest-frame lookup by simulation time."""
        if not self.snapshots:
            raise ValueError("no snapshots loaded")
        times = np.asarray([s.time for s in self.snapshots])
        return int(np.argmin(np.abs(times - t_ps)))
