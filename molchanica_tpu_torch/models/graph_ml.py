"""Non-NN graph ML: WL kernel, graphlet counts, path/overlap features.

Reference parity: src/therapeutic/non_nn_ml.rs — classical graph-level
features (Hamilton 2020 taxonomy): Weisfeiler-Lehman color histograms,
size-3 graphlet counts, path-based features, local-overlap and
Leicht-Holme-Newman similarity statistics, plus the spatial-adjacency
constructor used on 3D conformers. Host-side numpy (feature extraction, not
the MD hot path).

Copy of molchanica_tpu.models.graph_ml:
the same host code, so its results equal the reference's bit for bit.
"""
from __future__ import annotations

import hashlib
from collections import Counter, deque
from typing import Dict, List, Sequence

import numpy as np


def build_spatial_adj(dist_mat: np.ndarray, r_cut: float = 2.0
                      ) -> List[List[int]]:
    """Adjacency from a distance matrix (reference
    build_spacial_analysis_adj, non_nn_ml.rs:272)."""
    n = dist_mat.shape[0]
    adj: List[List[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(i + 1, n):
            if dist_mat[i, j] <= r_cut:
                adj[i].append(j)
                adj[j].append(i)
    return adj


def wl_colors(adj: Sequence[Sequence[int]], labels: Sequence[str],
              n_iters: int = 3) -> List[Counter]:
    """Weisfeiler-Lehman refinement: per-iteration color histograms."""
    colors = [str(l) for l in labels]
    out = [Counter(colors)]
    for _ in range(n_iters):
        nxt = []
        for i in range(len(colors)):
            sig = colors[i] + "|" + ",".join(
                sorted(colors[j] for j in adj[i]))
            nxt.append(hashlib.blake2s(sig.encode(),
                                       digest_size=8).hexdigest())
        colors = nxt
        out.append(Counter(colors))
    return out


def wl_kernel(adj_a, labels_a, adj_b, labels_b, n_iters: int = 3) -> float:
    """Normalized WL subtree kernel between two labeled graphs."""
    ha = wl_colors(adj_a, labels_a, n_iters)
    hb = wl_colors(adj_b, labels_b, n_iters)

    def dot(x: Counter, y: Counter) -> float:
        return float(sum(v * y.get(k, 0) for k, v in x.items()))

    k = sum(dot(a, b) for a, b in zip(ha, hb))
    kaa = sum(dot(a, a) for a in ha)
    kbb = sum(dot(b, b) for b in hb)
    return k / max(np.sqrt(kaa * kbb), 1e-12)


def graphlet_size_3_features(adj: Sequence[Sequence[int]]) -> np.ndarray:
    """(triangles, open wedges, independent-ish triples) normalized
    (reference graphlet_size_3_features, non_nn_ml.rs:323)."""
    n = len(adj)
    nbr = [set(a) for a in adj]
    tri = 0
    wedge = 0
    for i in range(n):
        ni = sorted(nbr[i])
        for x in range(len(ni)):
            for y in range(x + 1, len(ni)):
                if ni[y] in nbr[ni[x]]:
                    tri += 1
                else:
                    wedge += 1
    tri //= 3
    total_triples = n * (n - 1) * (n - 2) / 6 if n >= 3 else 1
    return np.asarray([tri, wedge, max(total_triples - tri - wedge, 0)],
                      np.float64) / max(total_triples, 1)


def path_based_features(adj: Sequence[Sequence[int]]) -> np.ndarray:
    """(diameter, mean eccentricity, mean shortest path, efficiency)
    over the largest connected component (non_nn_ml.rs:393)."""
    n = len(adj)
    if n == 0:
        return np.zeros(4)
    ecc = []
    sp_sum, sp_cnt, eff_sum = 0.0, 0, 0.0
    for s in range(n):
        dist = {s: 0}
        q = deque([s])
        far = 0
        while q:
            u = q.popleft()
            for v in adj[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    far = max(far, dist[v])
                    q.append(v)
        ecc.append(far)
        for u, d in dist.items():
            if d > 0:
                sp_sum += d
                sp_cnt += 1
                eff_sum += 1.0 / d
    return np.asarray([
        max(ecc), float(np.mean(ecc)),
        sp_sum / max(sp_cnt, 1),
        eff_sum / max(n * (n - 1), 1)])


def local_overlap_features(adj: Sequence[Sequence[int]]) -> np.ndarray:
    """(mean Jaccard, mean common-neighbor count) over edges
    (non_nn_ml.rs:447)."""
    nbr = [set(a) for a in adj]
    jac, com, cnt = 0.0, 0.0, 0
    for i in range(len(adj)):
        for j in adj[i]:
            if j <= i:
                continue
            inter = len(nbr[i] & nbr[j])
            union = len(nbr[i] | nbr[j])
            jac += inter / max(union, 1)
            com += inter
            cnt += 1
    return np.asarray([jac / max(cnt, 1), com / max(cnt, 1)])


def lhn_similarity_features(adj: Sequence[Sequence[int]]) -> np.ndarray:
    """Leicht-Holme-Newman similarity stats over edges
    (non_nn_ml.rs:485): mean, max, std of |N(i) ∩ N(j)| / (k_i k_j)."""
    nbr = [set(a) for a in adj]
    vals = []
    for i in range(len(adj)):
        for j in adj[i]:
            if j <= i:
                continue
            denom = max(len(nbr[i]) * len(nbr[j]), 1)
            vals.append(len(nbr[i] & nbr[j]) / denom)
    if not vals:
        return np.zeros(3)
    v = np.asarray(vals)
    return np.asarray([v.mean(), v.max(), v.std()])


def graph_analysis_features(adj: Sequence[Sequence[int]],
                            labels: Sequence[str],
                            wl_iters: int = 2) -> np.ndarray:
    """Concatenated classical feature vector (reference
    graph_analysis_features, non_nn_ml.rs:238): graphlets(3) + paths(4) +
    overlap(2) + LHN(3) + WL color-diversity per iteration(wl_iters+1)."""
    wl = wl_colors(adj, labels, wl_iters)
    wl_div = np.asarray([len(h) / max(sum(h.values()), 1) for h in wl])
    return np.concatenate([
        graphlet_size_3_features(adj),
        path_based_features(adj),
        local_overlap_features(adj),
        lhn_similarity_features(adj),
        wl_div,
    ])


def atom_graph_analysis_features(mol) -> np.ndarray:
    """Feature vector from a MoleculeCommon's bond graph
    (non_nn_ml.rs:213)."""
    return graph_analysis_features(mol.adjacency(), mol.elements)
