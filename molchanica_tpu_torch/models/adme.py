"""Hybrid GNN + MLP molecular property model (ADME/Tox predictor) in torch.

Reference: src/therapeutic/train.rs (Burn hybrid GNN+MLP, Adam + cosine
LR) with the atom-graph encoding of src/therapeutic/gnn/atom_bond.rs: atoms
as nodes with MULTIPLEX edge layers (covalent / angle / proper-dihedral /
spatial), padded adjacency + masks for fixed shapes (MAX_ATOMS), plus a
whole-molecule descriptor MLP branch and a component-graph branch.

Port of molchanica_tpu.models.adme. Featurization is its host numpy code,
copied operation for operation. The network is the flax module's math as a
``torch.nn.Module`` whose parameters map one to one onto the flax ones
(``params_from_flax``), so the committed weights load unchanged
(``load_reference_pickle``, which needs no JAX). Training and inference run
on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import math
import pickle
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..molecules.characterization import FEATURE_DIM, characterize
from ..molecules.common import MoleculeCommon

MAX_ATOMS = 64
N_EDGE_LAYERS = 4      # covalent / angle(1-3) / dihedral(1-4) / spatial
ATOM_FEATS = 16
MAX_COMPS = 12         # component-graph padding (reference infer.rs MAX_COMPS)
COMP_FEATS = 12
N_COMP_PASSES = 2
# flax.linen.LayerNorm's default epsilon (torch's is 1e-5)
LN_EPS = 1e-6
# the masked max pool's fill for padded atoms
MASK_FILL = -1e9
# flax's lecun_normal: a normal truncated at 2 std, divided by the std of
# that truncation so the variance stays 1 / fan_in
_TRUNC_STD = 0.87962566103423978

_ELEMENT_IDX = {"C": 0, "N": 1, "O": 2, "S": 3, "P": 4, "F": 5, "Cl": 6,
                "Br": 7, "I": 8, "H": 9}


@dataclass(frozen=True)
class AdmeModelConfig:
    hidden: int = 48
    n_message_passes: int = 3
    mlp_hidden: int = 64
    comp_hidden: int = 24        # component-graph branch width
    classification: bool = False


def featurize_mol(mol: MoleculeCommon, char=None) -> Tuple[np.ndarray, ...]:
    """-> (node_feats [A,F], adj [L,A,A], mask [A], desc [FEATURE_DIM],
    cnodes [C,CF], cadj [C,C], cmask [C])."""
    char = char or characterize(mol)
    el = [e.capitalize() for e in mol.elements]
    n = min(len(el), MAX_ATOMS)
    nodes = np.zeros((MAX_ATOMS, ATOM_FEATS), np.float32)
    adj = np.zeros((N_EDGE_LAYERS, MAX_ATOMS, MAX_ATOMS), np.float32)
    mask = np.zeros((MAX_ATOMS,), np.float32)
    mask[:n] = 1.0

    ring_atoms = set(a for r in char.rings for a in r)
    neighbors = mol.adjacency()
    for i in range(n):
        e = el[i]
        idx = _ELEMENT_IDX.get(e, 10)
        if idx < 11:
            nodes[i, idx] = 1.0
        nodes[i, 11] = len(neighbors[i]) / 4.0
        nodes[i, 12] = 1.0 if i in ring_atoms else 0.0
        # every neighbour counts, those past MAX_ATOMS too
        nodes[i, 13] = sum(1 for j in neighbors[i]
                           if el[j] == "H") / 4.0
        if mol.charges is not None:
            nodes[i, 14] = float(mol.charges[i])
        nodes[i, 15] = (mol.formal_charges[i]
                        if mol.formal_charges else 0)

    orders = mol.bond_orders or [1.0] * len(mol.bonds)
    for (i, j), o in zip(mol.bonds, orders):
        if i < n and j < n:
            adj[0, i, j] = adj[0, j, i] = float(o)
    # 1-3 (angle) layer
    for j in range(n):
        nb = [k for k in neighbors[j] if k < n]
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                adj[1, nb[a], nb[b]] = adj[1, nb[b], nb[a]] = 1.0
    # 1-4 (dihedral) layer
    for (j, k), o in zip(mol.bonds, orders):
        if j >= n or k >= n:
            continue
        for i in neighbors[j]:
            for l in neighbors[k]:
                if len({i, j, k, l}) == 4 and i < n and l < n:
                    adj[2, i, l] = adj[2, l, i] = 1.0
    # spatial layer (< 4.5 A, non-bonded), only for a placed molecule
    if mol.positions is not None and np.any(mol.positions):
        x = np.asarray(mol.positions)[:n]
        d = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
        close = (d < 4.5) & (d > 1e-6)
        adj[3, :n, :n] = close & (adj[0, :n, :n] == 0)

    desc = char.feature_vector()
    cnodes, cadj, cmask = featurize_components(mol)
    return nodes, adj, mask, desc, cnodes, cadj, cmask


_KIND_IDX = {"ring_system": 0, "linker": 1, "substituent": 2}


def featurize_components(mol: MoleculeCommon
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Component-graph encoding (reference gnn/component.rs): nodes are
    ring systems / linkers / substituents from the BRICS-flavoured
    decomposition; two components are adjacent when a covalent bond
    crosses them. -> (cnodes [C,F], cadj [C,C], cmask [C])."""
    from ..molecules.components import decompose

    comps = decompose(mol)[:MAX_COMPS]
    el = [e.capitalize() for e in mol.elements]
    cnodes = np.zeros((MAX_COMPS, COMP_FEATS), np.float32)
    cadj = np.zeros((MAX_COMPS, MAX_COMPS), np.float32)
    cmask = np.zeros((MAX_COMPS,), np.float32)
    owner = {}
    for ci, c in enumerate(comps):
        cmask[ci] = 1.0
        for a in c.atom_indices:
            owner[a] = ci
        els = [el[a] for a in c.atom_indices]
        heavy = [e for e in els if e != "H"]
        cnodes[ci, _KIND_IDX.get(c.kind, 2)] = 1.0
        cnodes[ci, 3] = len(heavy) / 8.0
        cnodes[ci, 4] = sum(1 for e in heavy if e not in ("C",)) / 4.0
        cnodes[ci, 5] = len(c.attachment_points) / 4.0
        cnodes[ci, 6] = 1.0 if "N" in heavy else 0.0
        cnodes[ci, 7] = 1.0 if "O" in heavy else 0.0
        cnodes[ci, 8] = 1.0 if "S" in heavy else 0.0
        cnodes[ci, 9] = 1.0 if any(e in ("F", "Cl", "Br", "I")
                                   for e in heavy) else 0.0
        if mol.formal_charges:
            cnodes[ci, 10] = sum(mol.formal_charges[a]
                                 for a in c.atom_indices)
        cnodes[ci, 11] = sum(1 for e in els if e == "H") / 8.0
    for i, j in mol.bonds:
        ci, cj = owner.get(i), owner.get(j)
        if ci is not None and cj is not None and ci != cj:
            cadj[ci, cj] = cadj[cj, ci] = 1.0
    return cnodes, cadj, cmask


def featurize_batch(mols) -> Tuple[np.ndarray, ...]:
    """featurize_mol over a list, stacked: the model's seven inputs."""
    feats = [featurize_mol(m) for m in mols]
    return tuple(np.stack([f[i] for f in feats]) for i in range(7))


def _layer_norm(ln: nn.LayerNorm, x):
    """flax.linen.LayerNorm: the fast variance E[x^2] - E[x]^2 clipped at
    0, and rsqrt(var + eps) * scale applied as one factor."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


class AdmeModel(nn.Module):
    """Message passing over multiplex adjacency + descriptor MLP +
    component-graph branch, fused head (the flax AdmeModel's math)."""

    def __init__(self, cfg: AdmeModelConfig = AdmeModelConfig()):
        super().__init__()
        self.cfg = cfg
        h, m, c = cfg.hidden, cfg.mlp_hidden, cfg.comp_hidden
        self.node_embed = nn.Linear(ATOM_FEATS, h)
        self.message = nn.ModuleList(
            nn.Linear(N_EDGE_LAYERS * h, h)
            for _ in range(cfg.n_message_passes))
        self.message_norm = nn.ModuleList(
            nn.LayerNorm(h, eps=LN_EPS) for _ in range(cfg.n_message_passes))
        self.desc1 = nn.Linear(FEATURE_DIM, m)
        self.desc2 = nn.Linear(m, m)
        self.comp_embed = nn.Linear(COMP_FEATS, c)
        self.comp_message = nn.ModuleList(
            nn.Linear(c, c) for _ in range(N_COMP_PASSES))
        self.comp_norm = nn.ModuleList(
            nn.LayerNorm(c, eps=LN_EPS) for _ in range(N_COMP_PASSES))
        self.head = nn.Linear(2 * h + m + c, m)
        self.out = nn.Linear(m, 1)

    def forward(self, nodes, adj, mask, desc, cnodes, cadj, cmask):
        # nodes [B,A,F], adj [B,L,A,A], mask [B,A], desc [B,D],
        # cnodes [B,C,CF], cadj [B,C,C], cmask [B,C] -> [B]
        mk = mask[..., None]
        h = self.node_embed(nodes) * mk
        for lin, ln in zip(self.message, self.message_norm):
            # [B, A, L*H]: layer l's adj @ h in columns l*H:(l+1)*H
            msgs = torch.einsum("blij,bjh->bilh", adj, h).flatten(2)
            h = _layer_norm(ln, h + F.relu(lin(msgs))) * mk
        denom = mask.sum(-1, keepdim=True).clamp_min(1.0)
        g_mean = (h * mk).sum(1) / denom
        g_max = torch.where(mk > 0, h, torch.full_like(h, MASK_FILL)
                            ).amax(1)

        d = F.relu(self.desc1(desc))
        d = F.relu(self.desc2(d))

        cmk = cmask[..., None]
        hc = self.comp_embed(cnodes) * cmk
        for lin, ln in zip(self.comp_message, self.comp_norm):
            mc = lin(torch.bmm(cadj, hc))
            hc = _layer_norm(ln, hc + F.relu(mc)) * cmk
        cden = cmask.sum(-1, keepdim=True).clamp_min(1.0)
        g_comp = (hc * cmk).sum(1) / cden

        z = torch.cat([g_mean, g_max, d, g_comp], dim=-1)
        z = F.relu(self.head(z))
        return self.out(z)[..., 0]


def _flax_order(cfg: AdmeModelConfig):
    """(torch module name, flax module name) in the flax module's creation
    order (its auto-names count Dense_i and LayerNorm_i in that order)."""
    dense, norm = [], []
    dense.append("node_embed")
    for p in range(cfg.n_message_passes):
        dense.append(f"message.{p}")
        norm.append(f"message_norm.{p}")
    dense += ["desc1", "desc2", "comp_embed"]
    for p in range(N_COMP_PASSES):
        dense.append(f"comp_message.{p}")
        norm.append(f"comp_norm.{p}")
    dense += ["head", "out"]
    return ([(t, f"Dense_{i}") for i, t in enumerate(dense)]
            + [(t, f"LayerNorm_{i}") for i, t in enumerate(norm)])


def params_from_flax(params, cfg: AdmeModelConfig = AdmeModelConfig()
                     ) -> Dict[str, torch.Tensor]:
    """The flax AdmeModel's parameter tree ({'params': {...}} or its inner
    dict) -> an AdmeModel state_dict: each Dense kernel [in, out] becomes
    weight [out, in], each LayerNorm scale weight; dtypes kept."""
    p = params.get("params", params)
    sd = {}
    for tname, fname in _flax_order(cfg):
        leaf = p[fname]
        w = leaf["kernel"].T if fname.startswith("Dense") else leaf["scale"]
        sd[f"{tname}.weight"] = torch.tensor(np.asarray(w))
        sd[f"{tname}.bias"] = torch.tensor(np.asarray(leaf["bias"]))
    return sd


def init_params(cfg: AdmeModelConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """flax's initialisation of the model, drawn from `generator` in the
    flax creation order: lecun_normal kernels (a truncated normal of std
    sqrt(1/fan_in) / _TRUNC_STD), zero biases, LayerNorm at ones and
    zeros."""
    model = AdmeModel(cfg)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for tname, fname in _flax_order(cfg):
        w = sd[f"{tname}.weight"]
        if fname.startswith("Dense"):
            std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
        else:
            w.fill_(1.0)
        sd[f"{tname}.bias"].zero_()
    return sd


@dataclass
class StandardScaler:
    """Target normalization (reference StandardScaler, train.rs:1345)."""
    mean: float = 0.0
    std: float = 1.0

    @staticmethod
    def fit(y):
        return StandardScaler(float(np.mean(y)), float(np.std(y) + 1e-9))

    def transform(self, y):
        return (np.asarray(y) - self.mean) / self.std

    def inverse(self, y):
        return np.asarray(y) * self.std + self.mean


# ---------------------------------------------------------------------
# The committed weights: pickles of the JAX package's train_target (jax
# arrays and two molchanica_tpu.models.adme objects), read without JAX.

def _rebuild_array(fun, args, arr_state, aval_state):
    """jax._src.array._reconstruct_array without its device_put: the numpy
    array it rebuilds first."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


_NP_RECONSTRUCT = np.zeros(1).__reduce__()[0]
_PICKLE_GLOBALS = {
    ("jax._src.array", "_reconstruct_array"): _rebuild_array,
    ("numpy._core.multiarray", "_reconstruct"): _NP_RECONSTRUCT,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    ("molchanica_tpu.models.adme", "AdmeModelConfig"): AdmeModelConfig,
    ("molchanica_tpu.models.adme", "StandardScaler"): StandardScaler,
}


class _ReferenceUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return _PICKLE_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not allowed in a weights "
                "pickle") from None


def load_reference_pickle(path) -> dict:
    """A weights file of the JAX package's train_target -> {'params' (numpy
    leaves), 'scaler', 'cfg', 'metrics', 'target'}, with no JAX: a
    restricted unpickler that refuses any global but the jax array
    rebuild, numpy's array and dtype, and the two classes above."""
    with open(path, "rb") as f:
        return _ReferenceUnpickler(f).load()


def save_weights(path, state_dict, scaler: StandardScaler,
                 cfg: AdmeModelConfig, metrics: dict, target: str):
    """The port's weights file: torch.save of plain types only, so that
    ``torch.load(weights_only=True)`` reads it."""
    torch.save({"state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()},
                "scaler": {"mean": scaler.mean, "std": scaler.std},
                "cfg": asdict(cfg), "metrics": dict(metrics),
                "target": target}, path)


def load_weights(path) -> dict:
    """A weights file of either package -> {'state_dict', 'scaler', 'cfg',
    'metrics', 'target'}: the JAX package's .pkl through
    load_reference_pickle, the port's own through torch.load with
    weights_only=True."""
    if str(path).endswith(".pkl"):
        blob = load_reference_pickle(path)
        cfg = blob["cfg"]
        return {"state_dict": params_from_flax(blob["params"], cfg),
                "scaler": blob["scaler"], "cfg": cfg,
                "metrics": blob.get("metrics", {}), "target": blob["target"]}
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return {"state_dict": blob["state_dict"],
            "scaler": StandardScaler(**blob["scaler"]),
            "cfg": AdmeModelConfig(**blob["cfg"]),
            "metrics": blob["metrics"], "target": blob["target"]}


def build_model(cfg: AdmeModelConfig, state_dict, device=None) -> AdmeModel:
    """An AdmeModel on `device` (the card unless "cpu") holding
    `state_dict`, in its dtype, in eval mode."""
    dev = resolve_device(device)
    dtype = next(iter(state_dict.values())).dtype
    model = AdmeModel(cfg).to(dtype)
    model.load_state_dict(state_dict)
    return model.to(dev).eval()


def model_inputs(feats, device, dtype=torch.float32):
    return tuple(torch.as_tensor(a, dtype=dtype).to(device) for a in feats)


@torch.no_grad()
def adme_forward(model: AdmeModel, feats) -> np.ndarray:
    """One batched forward of stacked featurize_batch arrays on the
    model's device -> the raw outputs (logits or scaled values), numpy."""
    p = next(model.parameters())
    return model(*model_inputs(feats, p.device, p.dtype)).cpu().numpy()


def postprocess(raw, scaler: Optional[StandardScaler],
                cfg: AdmeModelConfig):
    """Raw outputs -> predictions on the host: the sigmoid for
    classification, else the scaler's inverse."""
    if cfg.classification:
        with np.errstate(over="ignore"):     # exp(-raw) = inf gives 0
            return 1.0 / (1.0 + np.exp(-raw))
    return scaler.inverse(raw) if scaler else raw


def predict_adme(params, mols, scaler=None,
                 cfg: AdmeModelConfig = AdmeModelConfig(), device=None):
    """Batched inference (reference infer.rs): host featurization, one
    forward on the card (unless device="cpu"), the sigmoid or the
    scaler's inverse on the host. `params` is an AdmeModel state_dict."""
    return postprocess(adme_forward(build_model(cfg, params, device),
                                    featurize_batch(mols)), scaler, cfg)


def _cosine_decay(lr_steps: int):
    """optax.cosine_decay_schedule(lr, lr_steps) as a LambdaLR factor: 1
    at step 0, 0 from step lr_steps on."""
    def f(step):
        return 0.5 * (1.0 + math.cos(math.pi * min(step, lr_steps)
                                     / lr_steps))
    return f


def train_adme(
    mols, targets,
    cfg: AdmeModelConfig = AdmeModelConfig(),
    n_epochs: int = 60,
    lr: float = 3e-3,
    batch_size: int = 32,
    seed: int = 0,
    val_fraction: float = 0.15,
    device=None,
    *,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
):
    """Train on (MoleculeCommon list, float targets) on the card (unless
    device="cpu"). Returns (state_dict on the host, scaler, history of
    (epoch, last batch loss, val loss)). Adam + cosine decay (reference
    train.rs:37-44), with the JAX package's numpy split and shuffles, so
    the batches are its batches. `init_state` starts from given
    parameters (an AdmeModel state_dict) instead of the port's own flax
    initialisation drawn from a torch.Generator seeded with `seed`."""
    dev = resolve_device(device)
    feats = model_inputs(featurize_batch(mols), dev)
    y_raw = np.asarray(targets, np.float32)
    scaler = StandardScaler.fit(y_raw) if not cfg.classification \
        else StandardScaler()
    y = torch.as_tensor(np.asarray(scaler.transform(y_raw), np.float32)
                        if not cfg.classification else y_raw).to(dev)

    n = len(mols)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_fraction))
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    if init_state is None:
        init_state = init_params(cfg, torch.Generator().manual_seed(seed))
    model = AdmeModel(cfg)
    model.load_state_dict(init_state)
    model.to(dev)
    n_steps = max(1, (len(tr_idx) // batch_size)) * n_epochs
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, _cosine_decay(n_steps))

    def loss_fn(b):
        pred = model(*(a[b] for a in feats))
        if cfg.classification:
            return F.binary_cross_entropy_with_logits(pred, y[b])
        return torch.mean((pred - y[b]) ** 2)

    def step(b):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(torch.as_tensor(b, device=dev))
        loss.backward()
        opt.step()
        sched.step()
        return loss.detach()

    val_b = torch.as_tensor(val_idx, device=dev)
    history = []
    for epoch in range(n_epochs):
        rng.shuffle(tr_idx)
        for s in range(0, len(tr_idx) - batch_size + 1, batch_size):
            l = step(tr_idx[s:s + batch_size])
        if len(tr_idx) < batch_size:
            l = step(tr_idx)
        with torch.no_grad():
            vl = float(loss_fn(val_b))
        history.append((epoch, float(l), vl))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return state, scaler, history
