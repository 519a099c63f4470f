"""The schedule of colpair's CUDA kernel (csrc/colpair.cu), held to the
plain torch kernel on the CPU.

`colpair_work` models what the kernel visits: a grid of (cluster, part)
blocks, each cluster's window entries cut into 32-slot j chunks clipped
to [lo, hi) and dealt round-robin to the cluster's warps, and per chunk
the pairs that pass the masks and r^2 < rc^2, compacted into 32-lane
batches. For every instance kind (triangular per-slice and range tables,
the water filter, has_alch, symmetric, cross, and the shard with a halo
below its clusters) the model's compacted pairs must be exactly the pairs
`colpair_plain` counts (the same float32 r^2 expression on the same
inputs: no tolerance), and its chunks must tile every entry. One case
puts sites at the cutoff across box faces, where a chunk's j sites sit at
the far margin of the window.
"""
import dataclasses

import numpy as np
import pytest
import torch

from molchanica_tpu_torch.ops import colpair as T
from molchanica_tpu_torch.ops.pme import ewald_beta_for
from molchanica_tpu_torch.parallel.dryrun import sorted_colpair_state
from molchanica_tpu_torch.parallel.spatial_colpair import (block,
                                                           halo_depth_for)

torch.set_num_threads(1)

N_SITES, N_BASE, N_SOLUTE, RC = 700, 768, 100, 6.0
BOX = (21.0, 22.0, 23.0)


def _sorted(plan, x, props, mask, box):
    """Rows [S, 8] and keys of the per-site sort of (x, props)."""
    bt = torch.tensor(box)
    perm, keys, _, ovf = T.make_sort_fn(plan)(torch.tensor(x), bt,
                                              torch.tensor(mask))
    assert int(ovf) == 0
    xw = torch.tensor(x) - bt * torch.floor(torch.tensor(x) / bt)
    xs = torch.cat([xw, torch.full((1, 3), 1e6)])[perm]
    pr = torch.cat([torch.tensor(props), torch.zeros((1, 5))])[perm]
    return torch.cat([xs, pr], 1), keys, perm


def _props(rng, n_base, n, n_solute):
    """q sqrt(kC), sigma/2, 2 sqrt(eps), couple mask (the first 5 sites)
    and group id + 1: the solute sites one group each, the rest waters of
    three sites (0 for padded slots)."""
    idx = np.arange(n_base)
    gid = np.where(idx < n_solute, idx + 1.0,
                   n_solute + 1.0 + (idx - n_solute) // 3)
    return np.stack([rng.normal(0, 3.0, n_base),
                     rng.uniform(1.3, 1.7, n_base),
                     rng.uniform(0.3, 0.9, n_base),
                     (idx < 5).astype(np.float64),
                     gid * (idx < n)], 1).astype(np.float32)


def _water_range():
    return (float(N_SOLUTE + 1), float(N_SOLUTE + 1 + N_SITES))


def _random_case(seed=5, extra=None):
    """Plan, rows and box of N_SITES random sites (per-site sort); `extra`
    ([m, 3] positions) replaces the first m sites."""
    rng = np.random.default_rng(seed)
    box = np.asarray(BOX, np.float32)
    x = (rng.uniform(0, 1, (N_BASE, 3)) * box).astype(np.float32)
    if extra is not None:
        x[:len(extra)] = extra
    x[N_SITES:] = 0.0
    mask = (np.arange(N_BASE) < N_SITES).astype(np.float32)
    props = _props(rng, N_BASE, N_SITES, N_SOLUTE)
    plan = T.plan_columns(box, RC, ewald_beta_for(RC, 1e-5), N_SITES, N_BASE,
                          skin=0.5)
    rows, keys, perm = _sorted(plan, x, props, mask, box)
    return dict(plan=plan, rows=rows, keys=keys, perm=perm, x=x, box=box,
                props=props, mask=mask)


@pytest.fixture(scope="module")
def case():
    return _random_case()


def _tables(c, psk, triangular=True):
    rows = c["rows"]
    wl, nw, ovf = T.make_window_fn(c["plan"], per_slice_k=psk,
                                   triangular=triangular)(
        rows[:, :3], c["keys"], torch.tensor(c["box"]), rows[:, 7])
    assert int(ovf) == 0
    return wl, nw


def _check(rows, pT, wl, nw, box, cfg, couple=None, i_base=None):
    """The model against colpair_plain on one instance's inputs: the same
    pair count and keys, chunks that tile every entry, and a round-robin
    deal of each cluster's chunks over its warps. Returns the model."""
    box = torch.as_tensor(box)
    stats = {"keys": None}
    T.colpair_plain(rows, pT, wl, nw, box, cfg, couple, stats=stats,
                    i_base=i_base)
    work = T.colpair_work(rows, pT, wl, nw, box, cfg, i_base=i_base,
                          keys=True)
    assert stats["pairs"] > 0
    assert work["pairs"] == stats["pairs"]
    assert torch.equal(work["keys"], stats["keys"])
    # compaction: full batches but for each chunk's last
    tb = work["table"]
    assert work["batches"] == int(((tb["pairs"] + 31) // 32).sum())
    assert work["batches"] - work["chunks"] <= work["pairs"] // 32
    assert 0.0 < work["lane_use"] <= 1.0
    # chunks: at most 32 slots, inside their entry, tiling it exactly
    NC = rows.shape[0] // T.ICL
    K = wl.shape[1] // 3
    w3 = wl.reshape(NC, K, 3).long()
    lo = w3[tb["cluster"], tb["entry"], 0]
    hi = w3[tb["cluster"], tb["entry"], 1]
    size = tb["hi"] - tb["lo"]
    assert bool(((size > 0) & (size <= T.CHUNK)).all())
    assert bool(((tb["lo"] >= lo) & (tb["hi"] <= hi)).all())
    covered = torch.zeros(NC * K, dtype=torch.int64)
    covered.index_add_(0, tb["cluster"] * K + tb["entry"], size)
    act = torch.arange(K)[None, :] < nw.long()[:, None]
    want = torch.where(act, torch.clamp_min(w3[..., 1] - w3[..., 0], 0), 0)
    assert torch.equal(covered, want.reshape(-1))
    assert work["slots"] == int(torch.clamp(
        torch.minimum(tb["hi"], torch.tensor(pT.shape[1])) - tb["lo"],
        min=0).sum())
    # the deal: warp loads of a cluster differ by at most one chunk
    G = work["parts"] * T.WORK_WARPS
    load = torch.zeros(NC * G, dtype=torch.int64)
    load.index_add_(0, tb["cluster"] * G + tb["warp"],
                    torch.ones_like(tb["warp"]))
    load = load.reshape(NC, G)
    assert bool((load.max(1).values - load.min(1).values <= 1).all())
    assert work["max_warp_chunks"] == -(-work["max_cluster_chunks"] // G)
    assert work["busy_warps"] == int((load > 0).sum())
    return work


@pytest.mark.parametrize("we", [False, True])
@pytest.mark.parametrize("psk", [64, 32, 0])
def test_triangular_tables(case, psk, we):
    """Per-slice tables (psk 64, and 32, a table just wide enough) and range
    tables (psk 0: entries of many chunks, cut among warps)."""
    wl, nw = _tables(case, psk)
    kern = T.ColpairDirect(case["plan"], we, range_tables=psk == 0)
    work = _check(case["rows"], case["rows"].T.contiguous(), wl, nw,
                  case["box"], kern.cfg)
    if psk == 0:
        # range entries span several chunks, each dealt to its own warp
        tb = work["table"]
        ent = tb["cluster"] * wl.shape[1] + tb["entry"]
        assert int(torch.unique(ent, return_counts=True)[1].max()) > 1
        assert torch.unique(ent * 4096 + tb["warp"]).numel() \
            == work["chunks"]


@pytest.mark.parametrize("mode", ["coul", "lj", "full"])
def test_water_filter(case, mode):
    wl, nw = _tables(case, 64)
    kern = T.ColpairDirect(case["plan"], False, mode=mode,
                           water_filter=_water_range())
    work = _check(case["rows"], case["rows"].T.contiguous(), wl, nw,
                  case["box"], kern.cfg)
    plain = T.ColpairDirect(case["plan"], False, mode=mode)
    assert work["pairs"] < T.colpair_work(
        case["rows"], case["rows"].T.contiguous(), wl, nw,
        torch.tensor(case["box"]), plain.cfg)["pairs"]


@pytest.mark.parametrize("psk", [64, 0])
@pytest.mark.parametrize("mode", ["full", "coul"])
def test_has_alch(case, mode, psk):
    wl, nw = _tables(case, psk)
    kern = T.ColpairDirect(case["plan"], True, mode=mode, has_alch=True,
                           range_tables=psk == 0,
                           water_filter=(_water_range() if mode == "coul"
                                         else None))
    _check(case["rows"], case["rows"].T.contiguous(), wl, nw, case["box"],
           kern.cfg, couple=torch.tensor(0.5))


@pytest.mark.parametrize("alch", [False, True])
@pytest.mark.parametrize("psk", [64, 0])
def test_symmetric(case, psk, alch):
    """Every ordered pair from its i side, the self guard; twice the
    triangular table's pairs on the same state."""
    rows, pT = case["rows"], case["rows"].T.contiguous()
    wl, nw = _tables(case, psk, triangular=False)
    kern = T.ColpairDirect(case["plan"], False, triangular=False,
                           has_alch=alch, range_tables=psk == 0)
    work = _check(rows, pT, wl, nw, case["box"], kern.cfg,
                  couple=torch.tensor(0.5) if alch else None)
    wl_t, nw_t = _tables(case, psk)
    tri = T.colpair_work(rows, pT, wl_t, nw_t, torch.tensor(case["box"]),
                         T.ColpairDirect(case["plan"], False).cfg)
    assert work["pairs"] == 2 * tri["pairs"]


@pytest.mark.parametrize("psk", [64, 0])
def test_cross(case, psk):
    """The solute subset (the first N_SOLUTE sites) against the master
    array: water j always kept, other j above the i's group id."""
    c = case
    plan = c["plan"]
    cap = N_SOLUTE + T.ICL * plan.n_cols
    plan_sub = dataclasses.replace(plan, n_sorted=((cap + 127) // 128) * 128,
                                   n_base=N_SOLUTE)
    rows_s, keys_s, _ = _sorted(plan_sub, c["x"][:N_SOLUTE],
                                c["props"][:N_SOLUTE],
                                np.ones(N_SOLUTE, np.float32), c["box"])
    rm = c["rows"]
    wl, nw, ovf = T.make_window_fn(plan_sub, per_slice_k=psk,
                                   cross_j_size=rm.shape[0])(
        rows_s[:, :3], keys_s, torch.tensor(c["box"]), rows_s[:, 7],
        c["keys"], rm[:, 7])
    assert int(ovf) == 0
    wlo, whi = _water_range()
    kern = T.ColpairDirect(plan_sub, True, range_tables=psk == 0,
                           cross=(wlo, whi, rm.shape[0]))
    _check(rows_s, rm.T.contiguous(), wl, nw, c["box"], kern.cfg)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_halo_below_the_clusters(rank):
    """The shard variant on 2 blocks, 1,700 sites in a 40 A box, halo 1:
    the local j array is (block d - 1, block d, block d + 1), block 1
    twice. Rank 0's entries into block 1, above its clusters globally, map
    to the left copy, below them in local slots, so the triangle bound
    must not apply there; rank 1 has no such entry."""
    rng = np.random.default_rng(2)
    box = np.array([40.0, 21.0, 21.0])
    n, n_dev = 1700, 2
    x = rng.uniform(0, 1, (n, 3)) * box
    plan, rows, wl, nw, boxt = sorted_colpair_state(
        x, rng.normal(0, 0.4, n), rng.uniform(2.8, 3.4, n),
        rng.uniform(0.05, 0.2, n), box, RC, n_dev, device="cpu")
    h = halo_depth_for(plan, n_dev, wl, nw)
    assert h == 1
    S, B = plan.n_sorted, plan.n_sorted // n_dev
    ncl = plan.n_clusters // n_dev
    pT = torch.cat([rows[((rank + k) % n_dev) * B:((rank + k) % n_dev + 1)
                         * B] for k in range(-h, h + 1)]).T.contiguous()
    # entries to local slots, as ShardedColpair.local_inputs moves them
    w3 = block(wl, rank, n_dev).reshape(ncl, -1, 3).long()
    lo = torch.remainder(w3[..., 0] - (rank - h) * B, S)
    hi = lo + (w3[..., 1] - w3[..., 0])
    wl_loc = torch.stack([lo, hi, w3[..., 2]], 2).reshape(ncl, -1).int()
    nw_b = block(nw, rank, n_dev)
    i_base = h * B
    kern = T.ColpairDirect(plan, True, range_tables=True,
                           local_shape=(ncl, pT.shape[1], i_base))
    work = _check(block(rows, rank, n_dev).contiguous(), pT, wl_loc, nw_b,
                  boxt, kern.cfg, couple=torch.ones(()), i_base=i_base)
    used = torch.arange(w3.shape[1])[None, :] < nw_b.long()[:, None]
    below = used & (hi > lo) & (hi <= i_base) & (w3[..., 0] >= B)
    assert bool(below.any()) == (rank == 0)
    visited_below = work["table"]["pairs"][work["table"]["hi"] <= i_base]
    assert (int(visited_below.sum()) > 0) == (rank == 0)


def test_pairs_at_the_cutoff_across_box_faces():
    """Site pairs whose image distance crosses the x face, the z face and
    the xy edge at rc (1 - 1e-7), rc - 1e-3 and rc + 1e-3 (A): the j site
    sits at the far margin of the window's chunk. The model keeps exactly
    the plain version's pairs, the inside pairs are among them, the
    outside ones are not, and the ones at the cutoff count as near it."""
    L = np.asarray(BOX, np.float64)
    pairs, want = [], []
    for k, d in enumerate((RC * (1 - 1e-7), RC - 1e-3, RC + 1e-3)):
        y, z = 3.0 + 5.0 * k, 4.0 + 5.0 * k
        a = np.array([0.02, y, z])                  # across the x face
        pairs.append((a, a + np.array([L[0] - d, 0.0, 0.0])))
        a = np.array([10.0 + 2.0 * k, 2.0 + 5.0 * k, 0.03])   # the z face
        pairs.append((a, a + np.array([0.0, 0.0, L[2] - d])))
        s = d / np.sqrt(2.0)                         # the xy edge
        a = np.array([0.05, 0.05, 15.0 + 2.0 * k])
        pairs.append((a, np.array([0.05 + L[0] - s, 0.05 + L[1] - s,
                                   15.0 + 2.0 * k])))
        want += [d < RC] * 3
    extra = np.concatenate([np.stack(p) for p in pairs]).astype(np.float32)
    c = _random_case(seed=9, extra=extra)
    rows, pT = c["rows"], c["rows"].T.contiguous()
    for psk, tri in ((64, True), (0, True), (64, False)):
        wl, nw = _tables(c, psk, triangular=tri)
        cfg = T.ColpairDirect(c["plan"], True, range_tables=psk == 0,
                              triangular=tri).cfg
        work = _check(rows, pT, wl, nw, c["box"], cfg)
        stats = {}
        T.colpair_plain(rows, pT, wl, nw, torch.tensor(c["box"]), cfg,
                        stats=stats)
        assert stats["pairs_near_rc"] >= 3 * (1 if tri else 2)
        got = work["keys"] // 64
        i_row, j = got // pT.shape[1], got % pT.shape[1]
        slot = torch.empty(c["perm"].numel(), dtype=torch.int64)
        slot[c["perm"]] = torch.arange(c["perm"].numel())
        s_of = slot[:len(extra)]
        found = set(zip(i_row.tolist(), j.tolist()))
        for p, inside in enumerate(want):
            sa, sb = int(s_of[2 * p]), int(s_of[2 * p + 1])
            hit = (sa, sb) in found or (sb, sa) in found
            if p < 3:
                continue          # at rc within float32 roundoff: either
            assert hit == inside, (p, psk, tri)


def test_parts_and_counter_checks():
    """colpair_parts fills the grid from static shapes; the wrapper refuses
    a malformed pair counter before it reaches the library."""
    assert T.colpair_parts(1) == 64
    assert T.colpair_parts(152) == T.colpair_parts(328) == 8
    assert T.colpair_parts(66) == 16 and T.colpair_parts(54) == 20
    for nc in (1, 30, 54, 66, 152, 328, 416, 5000):
        p = T.colpair_parts(nc)
        assert 8 <= p <= 64
        assert nc * p >= min(T.GRID_BLOCKS, 64 * nc)
    c = _random_case()
    wl, nw = _tables(c, 64)
    kern = T.ColpairDirect(c["plan"], False)
    rows = c["rows"]
    for bad in (torch.zeros(2, dtype=torch.int64),
                torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError):
            T.colpair_cuda(kern.cfg, rows, rows.T.contiguous(), wl, nw,
                           torch.tensor(c["box"]),
                           kern.params(rows.device), counts=bad)
