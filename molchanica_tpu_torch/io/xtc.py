"""GROMACS XTC compressed-trajectory reader/writer.

Copy of molchanica_tpu.io.xtc:
the same host code, so its results equal the reference's bit for bit.

Binary layout per the public xdrfile spec (xdrfile_xtc.c / xdrfile.c):
each frame is an XDR record — magic 1995, natoms, step, time, 3x3 box
(nm, big-endian floats), then the xdr3dfcoord block: natoms, precision,
integer bounding box (minint/maxint), smallidx, compressed byte count and
the bit-packed coordinate stream.

Encoder strategy: coordinates are quantized to ints at `precision` and every
atom is emitted as one full-width "large" triplet (sizeofints packing of the
bounding-box ranges) followed by a 0 flag bit ("no small-diff run follows").
This is a strictly valid stream for the reference decoder — the run/delta
machinery is an optional encoder optimization — and still packs ~50-55 bits
per atom vs 96 for raw floats. The reader implements the full decoder
(large triplets, flag/runlength small-diff runs, smallidx adaptation), so
externally produced XTC files read correctly too.

Positions are stored in nm; this framework works in Angstrom (conversion at
the boundary, matching io/trr.py).

Reference parity: src/md/trajectory.rs:29-86 (the Rust viewer's XTC path).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

_MAGIC = 1995
A_TO_NM = 0.1
NM_TO_A = 10.0

_FIRSTIDX = 9
# magicints[FIRSTIDX + k] = floor(2^(3 + k/3)); first FIRSTIDX entries 0
_MAGICINTS = [0] * _FIRSTIDX + [
    int(2.0 ** (3.0 + k / 3.0)) for k in range(64)
]
_LASTIDX = len(_MAGICINTS)


@dataclass
class XtcFrame:
    step: int
    time_ps: float
    box_extent: Optional[np.ndarray]      # [3] A (diagonal) or None
    positions: np.ndarray                 # [n, 3] A


# ---------------------------------------------------------------------------
# Bit packing (xdrfile.c encodebits / encodeints, big-endian bit order)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0          # bit accumulator (int)
        self.nbits = 0

    def put(self, value: int, nbits: int):
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def put_big(self, value: int, nbits: int):
        """encodeints path for widths > 32 handled transparently here
        (python ints are arbitrary precision)."""
        self.put(value, nbits)

    def finish(self) -> bytes:
        if self.nbits:
            self.bytes.append((self.acc << (8 - self.nbits)) & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.bytes)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def get(self, nbits: int) -> int:
        while self.nbits < nbits:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = (self.acc << 8) | b
            self.nbits += 8
        self.nbits -= nbits
        v = (self.acc >> self.nbits) & ((1 << nbits) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v


def _sizeofint(size: int) -> int:
    n = 0
    while size > 0:
        size >>= 1
        n += 1
    return n


def _sizeofints(sizes) -> int:
    """Bits needed to encode a tuple with mixed radices (xdrfile
    sizeofints): total bits of prod(sizes)."""
    prod = 1
    for s in sizes:
        prod *= int(s)
    return _sizeofint(prod - 1) if prod > 1 else 1


def _encodeints(bw: _BitWriter, sizes, vals, nbits: int):
    """Pack vals (mixed-radix digits with radices `sizes`) into nbits."""
    v = 0
    for s, x in zip(reversed(sizes), reversed(vals)):
        v = v * int(s) + int(x)
    bw.put_big(v, nbits)


def _decodeints(br: _BitReader, sizes, nbits: int):
    v = br.get(nbits)
    out = []
    for s in sizes:
        out.append(v % int(s))
        v //= int(s)
    return out


# ---------------------------------------------------------------------------
# Frame writer
# ---------------------------------------------------------------------------

def _compress_coords(xyz_nm: np.ndarray, precision: float) -> bytes:
    n = xyz_nm.shape[0]
    out = bytearray()
    out += struct.pack(">i", n)
    if n <= 9:
        for v in xyz_nm.reshape(-1):
            out += struct.pack(">f", float(v))
        return bytes(out)
    out += struct.pack(">f", precision)
    ints = np.rint(np.asarray(xyz_nm, np.float64) * precision).astype(
        np.int64)
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    out += struct.pack(">3i", *[int(v) for v in minint])
    out += struct.pack(">3i", *[int(v) for v in maxint])
    sizes = (maxint - minint + 1).astype(np.int64)
    if (sizes > 0xFFFFFF).any():
        raise ValueError("xtc: coordinate range too large for precision")
    bitsize = _sizeofints(sizes)
    smallidx = _FIRSTIDX
    out += struct.pack(">i", smallidx)
    bw = _BitWriter()
    rel = ints - minint[None, :]
    for i in range(n):
        _encodeints(bw, sizes, rel[i], bitsize)
        bw.put(0, 1)                   # flag: no small-diff run follows
    payload = bw.finish()
    out += struct.pack(">i", len(payload))
    out += payload + b"\x00" * ((4 - len(payload) % 4) % 4)
    return bytes(out)


def _decompress_coords(buf: bytes, off: int):
    (n,) = struct.unpack_from(">i", buf, off)
    off += 4
    if n <= 9:
        vals = struct.unpack_from(f">{3 * n}f", buf, off)
        off += 12 * n
        return np.asarray(vals, np.float64).reshape(n, 3), n, off
    (precision,) = struct.unpack_from(">f", buf, off)
    off += 4
    minint = np.asarray(struct.unpack_from(">3i", buf, off), np.int64)
    off += 12
    maxint = np.asarray(struct.unpack_from(">3i", buf, off), np.int64)
    off += 12
    (smallidx,) = struct.unpack_from(">i", buf, off)
    off += 4
    (nbytes,) = struct.unpack_from(">i", buf, off)
    off += 4
    payload = buf[off:off + nbytes]
    off += nbytes + ((4 - nbytes % 4) % 4)

    sizes = maxint - minint + 1
    use_separate = bool((sizes > 0xFFFFFF).any())
    bitsizeint = [_sizeofint(int(s)) for s in sizes]
    bitsize = 0 if use_separate else _sizeofints(sizes)
    br = _BitReader(payload)
    coords = np.zeros((n, 3), np.int64)

    smaller = _MAGICINTS[max(smallidx - 1, _FIRSTIDX)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3

    i = 0
    prev = None
    while i < n:
        if bitsize == 0:
            this = [br.get(bitsizeint[k]) for k in range(3)]
        else:
            this = _decodeints(br, sizes, bitsize)
        this = [t + int(m) for t, m in zip(this, minint)]
        coords[i] = this
        i += 1
        flag = br.get(1)
        is_smaller = 0
        run = 0
        if flag:
            run = br.get(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            prev = list(this)
            for k in range(0, run, 3):
                d = _decodeints(br, sizesmall,
                                _sizeofints(sizesmall))
                d = [dd - smallnum for dd in d]
                this = [p + dd for p, dd in zip(prev, d)]
                if k == 0:
                    # water-swap: first run triplet precedes the large atom
                    coords[i - 1], this = np.asarray(this), \
                        list(coords[i - 1])
                    coords[i] = this
                else:
                    coords[i] = this
                prev = list(coords[i])
                i += 1
        if is_smaller < 0:
            smallnum = smaller
            smaller = (_MAGICINTS[max(smallidx - 2, _FIRSTIDX)] // 2
                       if smallidx > _FIRSTIDX else smaller)
            smallidx -= 1
        elif is_smaller > 0:
            smaller = smallnum
            smallidx += 1
            smallnum = _MAGICINTS[smallidx] // 2
        sizesmall = [_MAGICINTS[smallidx]] * 3

    xyz = coords.astype(np.float64) / precision
    return xyz, n, off


# ---------------------------------------------------------------------------
# Public API (mirrors io/trr.py)
# ---------------------------------------------------------------------------

def write_xtc(frames: List[XtcFrame], path=None,
              precision: float = 1000.0):
    """Serialize frames to XTC bytes (and optionally a file)."""
    out = bytearray()
    for fr in frames:
        pos = np.asarray(fr.positions, np.float64)
        n = pos.shape[0]
        out += struct.pack(">iii", _MAGIC, n, int(fr.step))
        out += struct.pack(">f", float(fr.time_ps))
        box = np.zeros((3, 3), np.float64)
        if fr.box_extent is not None:
            np.fill_diagonal(box, np.asarray(fr.box_extent) * A_TO_NM)
        out += struct.pack(">9f", *box.reshape(-1))
        out += _compress_coords(pos * A_TO_NM, precision)
    data = bytes(out)
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(data)
    return data


def read_xtc(path_or_bytes) -> List[XtcFrame]:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        buf = open(path_or_bytes, "rb").read()
    frames: List[XtcFrame] = []
    off = 0
    while off + 16 <= len(buf):
        magic, n, step = struct.unpack_from(">iii", buf, off)
        if magic != _MAGIC:
            raise ValueError(f"xtc: bad magic {magic} at offset {off}")
        off += 12
        (t,) = struct.unpack_from(">f", buf, off)
        off += 4
        box9 = np.asarray(struct.unpack_from(">9f", buf, off),
                          np.float64).reshape(3, 3)
        off += 36
        xyz_nm, n2, off = _decompress_coords(buf, off)
        assert n2 == n
        diag = np.diagonal(box9) * NM_TO_A
        box = diag if np.any(diag != 0.0) else None
        frames.append(XtcFrame(step=step, time_ps=float(t),
                               box_extent=box,
                               positions=xyz_nm * NM_TO_A))
    return frames
