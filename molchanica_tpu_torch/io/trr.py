"""GROMACS TRR trajectory reader/writer.

Copy of molchanica_tpu.io.trr:
the same host code, so its results equal the reference's bit for bit.

Binary layout per the public GROMACS t_trnheader spec (trrio.cpp): each
frame is an XDR-encoded record — magic 1993, version string "GMX_trn_file",
section sizes (ir/e/box/vir/pres/top/sym/x/v/f), natoms, step, nre, time,
lambda, then big-endian float arrays for box/x/v/f. Positions are stored in
nm (this framework works in Angstrom; conversion at the boundary).

Reference parity: src/md/trajectory.rs:29-86 (the Rust viewer's TRR path).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_MAGIC = 1993
_VERSION = "GMX_trn_file"
A_TO_NM = 0.1
NM_TO_A = 10.0


@dataclass
class TrrFrame:
    step: int
    time_ps: float
    box_extent: Optional[np.ndarray]      # [3] A (diagonal) or None
    positions: np.ndarray                 # [n, 3] A
    velocities: Optional[np.ndarray]      # [n, 3] A/ps
    forces: Optional[np.ndarray] = None
    lam: float = 0.0


def _xdr_string(s: str) -> bytes:
    b = s.encode()
    n = len(b) + 1                         # GROMACS writes strlen+1
    pad = (4 - (n % 4)) % 4
    return struct.pack(">ii", n, n) + b + b"\x00" + b"\x00" * pad


def _read_xdr_string(buf, off):
    (n,), off = struct.unpack_from(">i", buf, off), off + 4
    n = n[0] if isinstance(n, tuple) else n
    (m,) = struct.unpack_from(">i", buf, off)
    off += 4
    s = buf[off:off + m - 1].decode(errors="replace")
    off += m + ((4 - (m % 4)) % 4)
    return s, off


def write_trr(frames: List[TrrFrame], path=None, double: bool = False):
    """Serialize frames to TRR bytes (and optionally a file)."""
    fmt = ">d" if double else ">f"
    fsize = 8 if double else 4
    out = bytearray()
    for fr in frames:
        n = int(np.asarray(fr.positions).shape[0])
        box_size = 9 * fsize if fr.box_extent is not None else 0
        x_size = 3 * n * fsize
        v_size = 3 * n * fsize if fr.velocities is not None else 0
        f_size = 3 * n * fsize if fr.forces is not None else 0
        out += struct.pack(">ii", _MAGIC, 13)          # magic, version
        out += _xdr_string(_VERSION)
        # ir, e, box, vir, pres, top, sym, x, v, f sizes
        out += struct.pack(">iiiiiiiiii", 0, 0, box_size, 0, 0, 0, 0,
                           x_size, v_size, f_size)
        out += struct.pack(">iii", n, fr.step, 0)       # natoms, step, nre
        if double:
            out += struct.pack(">dd", fr.time_ps, fr.lam)
        else:
            out += struct.pack(">ff", fr.time_ps, fr.lam)
        if fr.box_extent is not None:
            box = np.zeros((3, 3))
            box[np.diag_indices(3)] = np.asarray(fr.box_extent) * A_TO_NM
            out += box.astype(">f8" if double else ">f4").tobytes()
        for arr in (fr.positions, fr.velocities, fr.forces):
            if arr is None:
                continue
            a = np.asarray(arr, np.float64) * A_TO_NM
            out += a.astype(">f8" if double else ">f4").tobytes()
    data = bytes(out)
    if path:
        open(path, "wb").write(data)
    return data


def read_trr(path_or_bytes) -> List[TrrFrame]:
    buf = path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray)) \
        else open(path_or_bytes, "rb").read()
    frames = []
    off = 0
    while off < len(buf):
        magic, _ver = struct.unpack_from(">ii", buf, off)
        off += 8
        if magic != _MAGIC:
            raise ValueError(f"bad TRR magic {magic}")
        _s, off = _read_xdr_string(buf, off)
        (ir, e, box_size, vir, pres, top, sym, x_size, v_size,
         f_size) = struct.unpack_from(">iiiiiiiiii", buf, off)
        off += 40
        natoms, step, _nre = struct.unpack_from(">iii", buf, off)
        off += 12
        double = box_size == 72 or x_size == 24 * natoms
        if double:
            t, lam = struct.unpack_from(">dd", buf, off)
            off += 16
        else:
            t, lam = struct.unpack_from(">ff", buf, off)
            off += 8
        ftype = ">f8" if double else ">f4"
        fsize = 8 if double else 4

        def arr(count):
            nonlocal off
            a = np.frombuffer(buf, ftype, count, off).astype(np.float64)
            off += count * fsize
            return a

        box_extent = None
        if box_size:
            box = arr(9).reshape(3, 3)
            box_extent = np.diag(box) * NM_TO_A
        x = arr(3 * natoms).reshape(natoms, 3) * NM_TO_A if x_size else None
        v = arr(3 * natoms).reshape(natoms, 3) * NM_TO_A if v_size else None
        f = arr(3 * natoms).reshape(natoms, 3) * NM_TO_A if f_size else None
        frames.append(TrrFrame(step=step, time_ps=float(t),
                               box_extent=box_extent, positions=x,
                               velocities=v, forces=f, lam=float(lam)))
    return frames
