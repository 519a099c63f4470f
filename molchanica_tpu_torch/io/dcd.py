"""DCD binary trajectory reader/writer (CHARMM/NAMD convention).

Copy of molchanica_tpu.io.dcd:
the same host code, so its results equal the reference's bit for bit.

(reference: Trajectory over TRR/XTC/DCD/in-memory, src/md/trajectory.rs:29-86
and SnapshotHandlers' dcd output)
"""
from __future__ import annotations

import struct

import numpy as np


def write_dcd(path, frames, box_extent=None, dt_ps: float = 0.002,
              save_interval: int = 1):
    """frames: [F, N, 3] A. Writes a CHARMM-format DCD with unit cell."""
    frames = np.asarray(frames, np.float32)
    nframes, natoms, _ = frames.shape
    with open(path, "wb") as f:
        def block(data: bytes):
            f.write(struct.pack("<i", len(data)))
            f.write(data)
            f.write(struct.pack("<i", len(data)))

        icntrl = [0] * 20
        icntrl[0] = nframes
        icntrl[1] = 1                    # first step
        icntrl[2] = save_interval
        icntrl[3] = nframes * save_interval
        icntrl[9] = int(dt_ps / 4.888821e-2 * 1000) & 0x7FFFFFFF  # AKMA-ish
        icntrl[10] = 1 if box_extent is not None else 0
        icntrl[19] = 24                  # CHARMM version flag
        hdr = b"CORD" + struct.pack("<20i", *icntrl)
        block(hdr)
        title = b"Created by molchanica-tpu".ljust(80)
        block(struct.pack("<i", 1) + title)
        block(struct.pack("<i", natoms))
        for fr in frames:
            if box_extent is not None:
                a, b, c = [float(v) for v in box_extent]
                cell = struct.pack("<6d", a, 90.0, b, 90.0, 90.0, c)
                block(cell)
            for ax in range(3):
                block(fr[:, ax].astype(np.float32).tobytes())
    return path


def read_dcd(path):
    """Returns (frames [F,N,3] A, box_extents or None)."""
    with open(path, "rb") as f:
        def block() -> bytes:
            raw = f.read(4)
            if len(raw) < 4:
                return b""
            n = struct.unpack("<i", raw)[0]
            data = f.read(n)
            f.read(4)
            return data

        hdr = block()
        assert hdr[:4] == b"CORD", "not a DCD file"
        icntrl = struct.unpack("<20i", hdr[4:84])
        nframes = icntrl[0]
        has_cell = icntrl[10] == 1
        block()                      # titles
        natoms = struct.unpack("<i", block())[0]
        frames, cells = [], []
        for _ in range(nframes):
            if has_cell:
                cell = block()
                if not cell:
                    break
                a, _, b, _, _, c = struct.unpack("<6d", cell)
                cells.append([a, b, c])
            xs = block(); ys = block(); zs = block()
            if not (xs and ys and zs):
                break
            x = np.frombuffer(xs, np.float32)
            y = np.frombuffer(ys, np.float32)
            z = np.frombuffer(zs, np.float32)
            frames.append(np.stack([x, y, z], axis=1))
        return (np.asarray(frames),
                np.asarray(cells) if cells else None)
