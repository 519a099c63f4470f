"""ProteinMPNN unconditional-probability network and sequence design in
torch.

Reference parity: the native Rust forward pass in
src/therapeutic/ddg/mpnn.rs:42-50 (HIDDEN=128, K=48, 16 RBF, 3 encoder + 3
decoder message-passing layers, `unconditional_probs` with no sequence
input) and the saturation ddG scan in ddg/mod.rs:349.

Port of molchanica_tpu.therapeutic.mpnn. Weights are a flat name -> tensor
dict in the converted-checkpoint layout (PyTorch Linear [out, in]), the
JAX package's layout too, so ``params_from_jax`` only moves arrays. The
work runs where the weights lie: ``init_weights`` and ``params_from_jax``
put them on the card unless device="cpu". Design and scoring take a
``torch.Generator`` where the reference takes a key; the decoding order
and the sampling noise are drawn from it on its own device, so a CPU
generator gives the card and the CPU the same draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

ALPHABET = "ACDEFGHIKLMNPQRSTVWYX"
HIDDEN = 128
K_NEIGHBORS = 48
NUM_RBF = 16
NUM_ATOM_PAIRS = 25
MAX_RELATIVE = 32
POS_IN = 2 * MAX_RELATIVE + 2          # 66 one-hot buckets
POS_EMB = 16
MESSAGE_SCALE = 30.0
FF_HIDDEN = 4 * HIDDEN
# design never emits X (the last letter): its logit is set to this
X_LOGIT = -1e9

# the 25 ordered (from, to) backbone atom pairs; order is part of the
# learned weight layout (atoms: 0=N 1=Ca 2=C 3=O 4=Cb)
ATOM_PAIRS = [
    (1, 1), (0, 0), (2, 2), (3, 3), (4, 4), (1, 0), (1, 2), (1, 3),
    (1, 4), (0, 2), (0, 3), (0, 4), (4, 2), (4, 3), (3, 2), (0, 1),
    (2, 1), (3, 1), (4, 1), (2, 0), (3, 0), (4, 0), (2, 4), (3, 4),
    (2, 3),
]


@dataclass
class Backbone:
    n: np.ndarray           # [L, 3]
    ca: np.ndarray
    c: np.ndarray
    o: np.ndarray
    chain_index: np.ndarray     # [L] int
    residue_index: np.ndarray   # [L] int

    def __len__(self):
        return self.n.shape[0]


def virtual_cb(n, ca, c):
    """Idealised Cb from backbone geometry (upstream's exact constants)."""
    b = ca - n
    cc = c - ca
    a = torch.cross(b, cc, dim=-1)
    return -0.5827343 * a + 0.5680283 * b - 0.5406747 * cc + ca


def _rbf(d):
    """[... ] -> [..., NUM_RBF] gaussian radial basis on linspace(2,22,16)."""
    mu = torch.linspace(2.0, 22.0, NUM_RBF, dtype=d.dtype, device=d.device)
    sigma = (22.0 - 2.0) / NUM_RBF
    return torch.exp(-(((d[..., None] - mu) / sigma) ** 2))


def _ln(p, prefix, x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p[f"{prefix}.weight"] \
        + p[f"{prefix}.bias"]


def _lin(p, prefix, x):
    return F.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def _message_mlp(p, prefix, x):
    # the encoder's node message reads w1..w3 and its edge message
    # w11..w13 (prefix "encoderI.w" and "encoderI.w1"); the decoder's
    # "decoderI.w" reads w1..w3. GELU is the exact erf form.
    h = F.gelu(_lin(p, f"{prefix}1", x))
    h = F.gelu(_lin(p, f"{prefix}2", h))
    return _lin(p, f"{prefix}3", h)


def knn_graph(ca, k):
    """[L, k] neighbor indices by Ca distance, ties broken by index
    (matching upstream topk determinism). The distance is the norm of the
    difference, as the reference computes it: cdist's matmul form rounds
    differently and reorders near-ties."""
    d = torch.linalg.norm(ca[:, None, :] - ca[None, :, :], dim=-1)
    return torch.argsort(d, dim=1, stable=True)[:, :k]


def edge_features(bb, nbr):
    """[L, K, POS_IN + 25*16] raw features."""
    n, ca, c, o, chain, resi = bb
    cb = virtual_cb(n, ca, c)
    atoms = torch.stack([n, ca, c, o, cb], dim=1)       # [L, 5, 3]
    L, k = nbr.shape
    same = chain[:, None] == chain[nbr]
    off = resi[:, None] - resi[nbr]
    bucket = torch.where(
        same, torch.clamp(off + MAX_RELATIVE, 0, 2 * MAX_RELATIVE),
        torch.full_like(off, 2 * MAX_RELATIVE + 1))
    pos = F.one_hot(bucket, POS_IN).to(ca.dtype)        # [L, K, 66]
    ai = torch.tensor([p[0] for p in ATOM_PAIRS], device=ca.device)
    aj = torch.tensor([p[1] for p in ATOM_PAIRS], device=ca.device)
    xi = atoms[:, ai, :][:, None, :, :]                 # [L, 1, 25, 3]
    xj = atoms[nbr][:, :, aj, :]                        # [L, K, 25, 3]
    d = torch.linalg.norm(xi - xj, dim=-1)              # [L, K, 25]
    rbf = _rbf(d).reshape(L, k, NUM_ATOM_PAIRS * NUM_RBF)
    return torch.cat([pos, rbf], dim=-1)


def _bb_arrays(params, backbone: Backbone):
    """The backbone as tensors on the weights' device, coordinates in
    their dtype."""
    w = params["w_out.weight"]

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=w.dtype).to(w.device)

    def i(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64
                               ).to(w.device)
    return (f(backbone.n), f(backbone.ca), f(backbone.c), f(backbone.o),
            i(backbone.chain_index), i(backbone.residue_index))


def _neighbors(h, nbr):
    """h [L, H] -> (h_i broadcast, h_j gathered), each [L, K, H]."""
    L, k = nbr.shape
    return h[:, None, :].expand(L, k, h.shape[-1]), h[nbr]


def _node_update(params, pre, h_v, msg_sum):
    h_v = _ln(params, pre + "norm1", h_v + msg_sum / MESSAGE_SCALE)
    dense = _lin(params, pre + "dense_out",
                 F.gelu(_lin(params, pre + "dense_in", h_v)))
    return _ln(params, pre + "norm2", h_v + dense)


def _encode(params, bb, k):
    """Edge featurization + 3 encoder layers -> (h_v, h_e, nbr)."""
    ca = bb[1]
    L = ca.shape[0]
    nbr = knn_graph(ca, k)                          # [L, K]
    raw = edge_features(bb, nbr)
    pos = _lin(params, "positional", raw[..., :POS_IN])
    emb = _lin(params, "edge_embedding",
               torch.cat([pos, raw[..., POS_IN:]], dim=-1))
    h_e = _ln(params, "norm_edges", emb)
    h_e = _lin(params, "w_e", h_e)                  # [L, K, H]
    h_v = torch.zeros((L, HIDDEN), dtype=h_e.dtype, device=h_e.device)
    for i in range(3):
        pre = f"encoder{i}."
        hvi, hvj = _neighbors(h_v, nbr)
        msg = _message_mlp(params, pre + "w",
                           torch.cat([hvi, h_e, hvj], dim=-1))
        h_v = _node_update(params, pre, h_v, msg.sum(1))
        hvi, hvj = _neighbors(h_v, nbr)
        h_e = _ln(params, pre + "norm3",
                  h_e + _message_mlp(params, pre + "w1",
                                     torch.cat([hvi, h_e, hvj], dim=-1)))
    return h_v, h_e, nbr


@torch.no_grad()
def forward(params: Dict[str, torch.Tensor], backbone: Backbone,
            k: int = K_NEIGHBORS):
    """Unconditional per-position log-probabilities [L, 21], on the
    weights' device."""
    L = len(backbone)
    k = min(k, L)
    h_v, h_e, nbr = _encode(params, _bb_arrays(params, backbone), k)
    zeros = torch.zeros_like(h_e)
    for i in range(3):
        pre = f"decoder{i}."
        hvi, hvj = _neighbors(h_v, nbr)
        msg = _message_mlp(params, pre + "w",
                           torch.cat([hvi, h_e, zeros, hvj], dim=-1))
        h_v = _node_update(params, pre, h_v, msg.sum(1))
    return torch.log_softmax(_lin(params, "w_out", h_v), dim=-1)


# ----------------------------------------------------------------------
# Autoregressive sequence design (the reference's external sequence-design
# adapter, src/external_tools/mpnn.rs, done natively: upstream ProteinMPNN
# sample() semantics — random decoding order, per-layer h_V cache frozen at
# each position's decode time, sequence context h_S visible only from
# already-decoded neighbors).

def _decode(params, enc, order, sequence=None, gumbel=None,
            temperature=1.0, fixed_mask=None, fixed_seq=None):
    """Decode the positions in `order` (host ints: a permutation of the L
    positions, or its first steps), running the 3 decoder layers for one
    position a step: frozen per-layer caches for neighbors decoded before
    it, encoder states for the rest. Positions left out of a shorter order
    stay undecoded (residue 0, zero rows).

    Teacher-forced when `sequence` (residue indices, host) is given; else
    each residue is argmax(logits / temperature + gumbel[step]) with X
    masked, or fixed_seq's where fixed_mask is set. The sampled residues
    stay on the device until the end: no host sync per step.
    Returns (residues [L] int64, log-softmax rows [L, 21] in position
    order; a sampled row has X at its X_LOGIT)."""
    h_v_enc, h_e, nbr = enc
    L, k = nbr.shape
    dev, dt = h_e.device, h_e.dtype
    order = [int(t) for t in order]
    rank = torch.full((L,), L, dtype=torch.int64, device=dev)
    rank[torch.as_tensor(order, device=dev)] = torch.arange(len(order),
                                                            device=dev)
    hv_stack = torch.zeros((4, L, HIDDEN), dtype=dt, device=dev)
    hv_stack[0] = h_v_enc
    h_s = torch.zeros((L, HIDDEN), dtype=dt, device=dev)
    seq = torch.zeros(L, dtype=torch.int64, device=dev)
    rows = torch.zeros((L, len(ALPHABET)), dtype=dt, device=dev)
    w_s = params["w_s.weight"]
    zeros_k = torch.zeros((k, HIDDEN), dtype=dt, device=dev)
    is_x = torch.arange(len(ALPHABET), device=dev) == len(ALPHABET) - 1
    forced = sequence if sequence is not None else fixed_seq
    if forced is not None:
        forced = torch.as_tensor(forced, dtype=torch.int64, device=dev)
    for t_rank, t in enumerate(order):
        nb = nbr[t]                                       # [K]
        vis = (rank[nb] < t_rank)[:, None]                # decoded before t
        h_es_t = torch.cat([h_e[t], h_s[nb]], dim=-1)     # [K, 2H]
        ctx_inv = torch.cat([h_e[t], zeros_k, h_v_enc[nb]], dim=-1)
        for li in range(3):
            pre = f"decoder{li}."
            ctx_vis = torch.cat([h_es_t, hv_stack[li][nb]], dim=-1)
            h_esv = torch.where(vis, ctx_vis, ctx_inv)
            h_v_t = hv_stack[li, t]
            inp = torch.cat([h_v_t.expand(k, HIDDEN), h_esv], dim=-1)
            msg = _message_mlp(params, pre + "w", inp)
            hv_stack[li + 1, t] = _node_update(params, pre, h_v_t,
                                               msg.sum(0))
        logits = _lin(params, "w_out", hv_stack[3, t])   # [21]
        if sequence is None:
            logits = torch.where(is_x, X_LOGIT, logits)
        if sequence is not None or (fixed_mask is not None
                                    and fixed_mask[t]):
            aa = forced[t:t + 1]
        else:
            aa = torch.argmax(logits / temperature + gumbel[t_rank]
                              ).view(1)
        rows[t] = torch.log_softmax(logits, dim=-1)
        seq[t] = aa[0]
        h_s[t] = w_s.index_select(0, aa)[0]
    return seq, rows


def _draw(generator: torch.Generator, L: int):
    """One sample's decoding order [L] and uniform noise [L, 21], drawn on
    the generator's device."""
    order = torch.randperm(L, generator=generator, device=generator.device)
    u = torch.rand((L, len(ALPHABET)), generator=generator,
                   device=generator.device, dtype=torch.float64)
    return order, u


@torch.no_grad()
def design_sequences(params: Dict[str, torch.Tensor], backbone: Backbone,
                     generator: torch.Generator, n_samples: int = 1,
                     temperature: float = 0.1, k: int = K_NEIGHBORS,
                     fixed_mask: Optional[np.ndarray] = None,
                     fixed_seq: Optional[str] = None):
    """Sample sequences for a backbone (native sequence design; the
    reference shells out to ProteinMPNN for this, external_tools/mpnn.rs).

    Returns (sequences: list[str], mean_log_prob: np.ndarray[n_samples]).
    `fixed_mask`/`fixed_seq` pin positions (redesign only the rest). Each
    sample draws its order and noise from `generator` (``_draw``).
    """
    L = len(backbone)
    k = min(k, L)
    enc = _encode(params, _bb_arrays(params, backbone), k)
    fm = None if fixed_mask is None else np.asarray(fixed_mask, bool)
    # as in the reference, a mask without a sequence pins index 0 ('A')
    fs = [0] * L if fixed_seq is None else [ALPHABET.index(c)
                                            for c in fixed_seq]
    seqs, lps = [], []
    for _ in range(n_samples):
        order, u = _draw(generator, L)
        u = u.to(enc[1].device).clamp(1e-300, 1.0)
        seq, rows = _decode(params, enc, order.tolist(),
                            gumbel=(-torch.log(-torch.log(u))).to(
                                enc[1].dtype),
                            temperature=temperature, fixed_mask=fm,
                            fixed_seq=fs)
        seqs.append(seq)
        lps.append(rows.gather(1, seq[:, None]).mean())
    seqs = torch.stack(seqs).cpu().numpy()
    return (["".join(ALPHABET[a] for a in s) for s in seqs],
            torch.stack(lps).cpu().numpy())


@torch.no_grad()
def conditional_log_probs(params: Dict[str, torch.Tensor],
                          backbone: Backbone, sequence: str,
                          generator: torch.Generator,
                          k: int = K_NEIGHBORS) -> np.ndarray:
    """Teacher-forced per-position log P(aa_i | backbone, aa_{<i in a
    random decoding order}) — the conditional scoring mode (upstream
    ProteinMPNN `forward`; used for sequence recovery / design ranking).
    The order is a randperm drawn from `generator`."""
    L = len(backbone)
    k = min(k, L)
    enc = _encode(params, _bb_arrays(params, backbone), k)
    order = torch.randperm(L, generator=generator, device=generator.device)
    seq = [ALPHABET.index(c) for c in sequence]
    idx, rows = _decode(params, enc, order.tolist(), sequence=seq)
    return rows.gather(1, idx[:, None])[:, 0].cpu().numpy()


def _weight_shapes() -> Dict[str, tuple]:
    shapes: Dict[str, tuple] = {
        "positional.weight": (POS_EMB, POS_IN),
        "positional.bias": (POS_EMB,),
        "edge_embedding.weight": (HIDDEN, POS_EMB + NUM_ATOM_PAIRS * NUM_RBF),
        "edge_embedding.bias": (HIDDEN,),
        "norm_edges.weight": (HIDDEN,), "norm_edges.bias": (HIDDEN,),
        "w_e.weight": (HIDDEN, HIDDEN), "w_e.bias": (HIDDEN,),
        "w_s.weight": (21, HIDDEN),       # sequence embedding (design path)
        "w_out.weight": (21, HIDDEN), "w_out.bias": (21,),
    }
    for i in range(3):
        p = f"encoder{i}."
        shapes.update({
            p + "w1.weight": (HIDDEN, 3 * HIDDEN), p + "w1.bias": (HIDDEN,),
            p + "w2.weight": (HIDDEN, HIDDEN), p + "w2.bias": (HIDDEN,),
            p + "w3.weight": (HIDDEN, HIDDEN), p + "w3.bias": (HIDDEN,),
            p + "w11.weight": (HIDDEN, 3 * HIDDEN), p + "w11.bias": (HIDDEN,),
            p + "w12.weight": (HIDDEN, HIDDEN), p + "w12.bias": (HIDDEN,),
            p + "w13.weight": (HIDDEN, HIDDEN), p + "w13.bias": (HIDDEN,),
            p + "dense_in.weight": (FF_HIDDEN, HIDDEN),
            p + "dense_in.bias": (FF_HIDDEN,),
            p + "dense_out.weight": (HIDDEN, FF_HIDDEN),
            p + "dense_out.bias": (HIDDEN,),
            p + "norm1.weight": (HIDDEN,), p + "norm1.bias": (HIDDEN,),
            p + "norm2.weight": (HIDDEN,), p + "norm2.bias": (HIDDEN,),
            p + "norm3.weight": (HIDDEN,), p + "norm3.bias": (HIDDEN,),
        })
    for i in range(3):
        p = f"decoder{i}."
        shapes.update({
            p + "w1.weight": (HIDDEN, 4 * HIDDEN), p + "w1.bias": (HIDDEN,),
            p + "w2.weight": (HIDDEN, HIDDEN), p + "w2.bias": (HIDDEN,),
            p + "w3.weight": (HIDDEN, HIDDEN), p + "w3.bias": (HIDDEN,),
            p + "dense_in.weight": (FF_HIDDEN, HIDDEN),
            p + "dense_in.bias": (FF_HIDDEN,),
            p + "dense_out.weight": (HIDDEN, FF_HIDDEN),
            p + "dense_out.bias": (HIDDEN,),
            p + "norm1.weight": (HIDDEN,), p + "norm1.bias": (HIDDEN,),
            p + "norm2.weight": (HIDDEN,), p + "norm2.bias": (HIDDEN,),
        })
    return shapes


def init_weights(generator: torch.Generator, dtype=torch.float32,
                 device=None) -> Dict[str, torch.Tensor]:
    """Random weights with the exact converted-checkpoint layout
    (PyTorch Linear [out, in]), on the card unless device="cpu": normal /
    sqrt(fan_in) matrices drawn from `generator` in sorted name order,
    zero biases, LayerNorms at ones and zeros."""
    dev = resolve_device(device)
    out = {}
    for name, shp in sorted(_weight_shapes().items()):
        if name.endswith(".bias") or name.startswith("norm") \
                or ".norm" in name:
            w = torch.ones(shp, dtype=dtype) if name.endswith("weight") \
                else torch.zeros(shp, dtype=dtype)
        else:
            w = torch.randn(shp, generator=generator, dtype=dtype,
                            device=generator.device) / math.sqrt(shp[-1])
        out[name] = w.to(dev)
    return out


def params_from_jax(params, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's flat weights (or a converted checkpoint's arrays)
    -> tensors of the same dtype on the card unless device="cpu". The
    layout is already PyTorch's, so names and shapes stay."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v)).to(dev)
            for k, v in params.items()}


def ddg_scan(log_probs, wt_sequence: str):
    """Saturation mutagenesis: ddg[i, aa] = -(logP[i, aa] - logP[i, wt]).
    Positive = destabilizing (reference ddg/mod.rs:320)."""
    lp = log_probs.detach().cpu().numpy() if torch.is_tensor(log_probs) \
        else np.asarray(log_probs)
    out = np.zeros_like(lp)
    for i, wt in enumerate(wt_sequence):
        wt_i = ALPHABET.index(wt)
        out[i] = -(lp[i] - lp[i, wt_i])
    return out
