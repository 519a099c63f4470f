"""The block-pair accumulation probe (port of scripts/probe_prefetch.py).

For cluster c (64 rows) and window entry w < min(nw[c], W), with slice
s = sl[c, w] of 128 j slots:

    o[c's rows, 0]  += sum_j (rows[i, 0] - pT[0, j])^2   over slice s
    o2[0, slice s]  += sum_i (rows[i, 0] - pT[0, j])^2   over c's rows

o is re-zeroed per cluster (a cluster with no entry has zero rows), o2 is
zeroed once, and every other column of o and row of o2 stays zero. The
probe tested the TPU toolchain's scalar prefetch and a whole-array
accumulator; here it is csrc/probe_prefetch.cu for CUDA tensors and
`probe_plain` for CPU tensors.

    python -m molchanica_tpu_torch.ops.probe_prefetch [--device cpu]

runs the script's case (NC = 16 clusters, W = 8 entries, S = 1,024 slots,
inputs from numpy's default_rng(0)) and checks it against a loop over
the entries.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import tracing

ICL = 64
LANES = 128


def probe_plain(nw, sl, rows, pT):
    """(o [NC*64, 8], o2 [8, S]) in plain torch. Entries past W, and slices
    outside [0, S / 128), are skipped, as the kernel skips them."""
    NC, W = sl.shape
    S = pT.shape[1]
    dev = rows.device
    n = torch.clamp(nw.long(), 0, W)
    s = sl.long()
    active = ((torch.arange(W, device=dev)[None, :] < n[:, None])
              & (s >= 0) & (s < S // LANES))                     # [NC, W]
    xi = rows[:, 0].reshape(NC, 1, ICL, 1)
    gid = torch.clamp(s, 0, S // LANES - 1)[..., None] * LANES \
        + torch.arange(LANES, device=dev)                         # [NC,W,L]
    jx = pT[0][gid][:, :, None, :]                                # [NC,W,1,L]
    d = xi - jx
    v = torch.where(active[..., None, None], d * d, torch.zeros_like(d))
    o = torch.zeros((NC * ICL, 8), dtype=rows.dtype, device=dev)
    o[:, 0] = v.sum(dim=(1, 3)).reshape(-1)
    o2 = torch.zeros((8, S), dtype=rows.dtype, device=dev)
    o2[0].index_add_(0, gid.reshape(-1), v.sum(dim=2).reshape(-1))
    return o, o2


def probe_cuda(nw, sl, rows, pT):
    """Launch csrc/probe_prefetch.cu on the current stream: (o, o2) as
    probe_plain. Counts no launch; `probe` does."""
    import ctypes

    from ..cuda_build import load_library

    dev = rows.device
    NC, W = sl.shape
    S = pT.shape[1]
    for name, t, dt, shape in (
            ("nw", nw, torch.int32, (NC,)), ("sl", sl, torch.int32, (NC, W)),
            ("rows", rows, torch.float32, (NC * ICL, 8)),
            ("pT", pT, torch.float32, (8, S))):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or tuple(t.shape) != shape:
            raise ValueError(f"probe: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}")
    if S % LANES:
        raise ValueError(f"probe: S = {S} is not a multiple of {LANES}")
    o = torch.empty((NC * ICL, 8), dtype=torch.float32, device=dev)
    o2 = torch.zeros((8, S), dtype=torch.float32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    err = load_library().probe_launch(
        NC, W, S, ptr(nw), ptr(sl), ptr(rows), ptr(pT), ptr(o), ptr(o2),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {err}")
    return o, o2


def probe(nw, sl, rows, pT):
    """(o, o2): the kernel for CUDA tensors (its launches counted in the
    tracing counter "probe_prefetch"), the plain version for CPU tensors."""
    if rows.device.type == "cpu":
        return probe_plain(nw, sl, rows, pT)
    out = probe_cuda(nw, sl, rows, pT)
    tracing.count("probe_prefetch")
    return out


def probe_inputs(NC=16, W=8, S=None, seed=0):
    """The script's inputs as numpy arrays (nw, sl, rows, pT): S = NC*64
    slots by default, rows normal, nw in [1, W], sl uniform over the
    slices."""
    S = NC * ICL if S is None else S
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(NC * ICL, 8)).astype(np.float32)
    if S == NC * ICL:
        pT = np.ascontiguousarray(rows.T)
    else:
        pT = rng.normal(size=(8, S)).astype(np.float32)
    nw = rng.integers(1, W + 1, size=(NC,)).astype(np.int32)
    sl = rng.integers(0, S // LANES, size=(NC, W)).astype(np.int32)
    return nw, sl, rows, pT


def probe_loop(nw, sl, rows, pT):
    """The script's reference: a numpy loop over clusters and entries."""
    NC, W = sl.shape
    S = pT.shape[1]
    o = np.zeros((NC * ICL, 8), np.float32)
    o2 = np.zeros((8, S), np.float32)
    for ci in range(NC):
        xi = rows[ci * ICL:(ci + 1) * ICL, 0:1]
        for w in range(min(int(nw[ci]), W)):
            s = int(sl[ci, w])
            jx = pT[0:1, s * LANES:(s + 1) * LANES]
            c = (xi - jx) ** 2
            o[ci * ICL:(ci + 1) * ICL, 0] += c.sum(1)
            o2[0, s * LANES:(s + 1) * LANES] += c.sum(0)
    return o, o2


def rel_errors(o, o2, o_ref, o2_ref):
    """The script's errors: max |difference| over max |reference|."""
    e1 = np.abs(o - o_ref).max() / max(np.abs(o_ref).max(), 1e-9)
    e2 = np.abs(o2 - o2_ref).max() / max(np.abs(o2_ref).max(), 1e-9)
    return float(e1), float(e2)


def main(argv=None) -> int:
    import argparse

    from ..device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    nw, sl, rows, pT = probe_inputs()
    t0 = time.perf_counter()
    o, o2 = probe(*(torch.as_tensor(a, device=dev) for a in (nw, sl, rows,
                                                             pT)))
    o, o2 = o.cpu().numpy(), o2.cpu().numpy()
    dt = time.perf_counter() - t0
    e1, e2 = rel_errors(o, o2, *probe_loop(nw, sl, rows, pT))
    print(f"compile+run {dt:.1f}s  rel_err o={e1:.2e} o2={e2:.2e}")
    ok = e1 < 1e-6 and e2 < 1e-6
    print("PROBE", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
