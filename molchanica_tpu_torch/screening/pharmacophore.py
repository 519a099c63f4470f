"""Pharmacophore models: feature types, auto-generation, geometric scoring.

Copy of molchanica_tpu.screening.pharmacophore:
the same host code, so its results equal the reference's bit for bit.

Reference: src/screening/pharmacophore.rs — PharmacophoreFeatType (:60),
Pharmacophore (+serialization :530-649), auto candidates (:651),
screen_ligs threaded batch scoring (:781), `score` matcher (:868-1175).

The matcher reproduces the reference's scoring semantics:
- per-feature Gaussian distance kernel with a tolerance sigma,
- directional modulation for projected donor/acceptor features (heavy->H
  direction for donors, lone-pair proxy for acceptors) and aromatic ring
  normals, mixed 70% spatial / 30% directional,
- greedy bijective matching ordered by feature strength: each ligand atom
  or ring is claimed by at most one pharmacophore feature,
- AND / OR feature relations (OR keeps the better alternative; AND halves
  both scores if either fails to match),
- a coverage penalty when fewer than half the features match, and
- an excluded-volume steric penalty (1 - 2*clash_frac) against a pocket
  volume (here: exclusion spheres or any `inside(p)` callable).
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..molecules.characterization import characterize
from ..molecules.common import MoleculeCommon

MATCH_THRESHOLD = 0.2          # per-feature gaussian score counting as "matched"
COVERAGE_FLOOR = 0.5           # fraction of features that must match


class PharmacophoreFeatType(str, Enum):
    # canonical names first (back-compat with round-2 JSON files), reference
    # aliases after (pharmacophore.rs:60-88)
    H_BOND_DONOR = "donor"
    H_BOND_ACCEPTOR = "acceptor"
    DONOR_PROJECTED = "donor_projected"
    ACCEPTOR_PROJECTED = "acceptor_projected"
    HYDROPHOBIC = "hydrophobic"
    HYDROPHILIC = "hydrophilic"
    AROMATIC = "aromatic"
    POSITIVE = "positive"        # reference: Cation
    NEGATIVE = "negative"        # reference: Anion

    @property
    def is_projected(self) -> bool:
        return self in (PharmacophoreFeatType.DONOR_PROJECTED,
                        PharmacophoreFeatType.ACCEPTOR_PROJECTED)

    @property
    def site_key(self) -> str:
        """The ligand-site pool this feature draws from (projected variants
        share the base pool, reference ligand_sites :929)."""
        m = {"donor_projected": "donor", "acceptor_projected": "acceptor"}
        return m.get(self.value, self.value)

    def disp_radius(self) -> float:
        """Display/indicative radius (reference disp_radius :195)."""
        return {"aromatic": 1.05, "hydrophobic": 1.0}.get(self.value, 0.6)


# canonical reference names
PharmacophoreFeatType.DONOR = PharmacophoreFeatType.H_BOND_DONOR
PharmacophoreFeatType.ACCEPTOR = PharmacophoreFeatType.H_BOND_ACCEPTOR
PharmacophoreFeatType.CATION = PharmacophoreFeatType.POSITIVE
PharmacophoreFeatType.ANION = PharmacophoreFeatType.NEGATIVE


@dataclass
class PharmacophoreFeat:
    feat_type: PharmacophoreFeatType
    position: np.ndarray                      # [3]
    radius: float = 1.5                       # tolerance sigma (A)
    weight: float = 1.0                       # reference `strength`
    posit_projected: Optional[np.ndarray] = None   # for *_PROJECTED types
    normal: Optional[np.ndarray] = None            # for AROMATIC

    @property
    def direction(self) -> Optional[np.ndarray]:
        """Feature direction: projected-point direction for H-bond features,
        ring normal for aromatics (reference feat_dir :1024-1037)."""
        if self.feat_type.is_projected and self.posit_projected is not None:
            d = np.asarray(self.posit_projected, float) - \
                np.asarray(self.position, float)
            n = np.linalg.norm(d)
            return d / n if n > 1e-8 else None
        if self.feat_type == PharmacophoreFeatType.AROMATIC and \
                self.normal is not None:
            n = np.linalg.norm(self.normal)
            return np.asarray(self.normal, float) / n if n > 1e-8 else None
        return None


@dataclass
class FeatureRelation:
    """AND/OR constraint between two features by index
    (reference FeatureRelation :333)."""
    kind: str                                  # "and" | "or"
    a: int
    b: int


@dataclass
class PhScreeningScore:
    """Score breakdown (reference PhScreeningScore :48)."""
    total: float
    feat_scores: List[float]
    feat_matched: List[bool]
    match_fraction: float
    clash_fraction: float = 0.0


@dataclass
class Pharmacophore:
    features: List[PharmacophoreFeat] = field(default_factory=list)
    feature_relations: List[FeatureRelation] = field(default_factory=list)
    name: str = ""
    # excluded volume: list of (center[3], radius) spheres, or any callable
    # p -> bool testing "inside the receptor volume"
    exclusion_spheres: List[Tuple[np.ndarray, float]] = \
        field(default_factory=list)

    # --- (de)serialization (reference custom byte format -> json here) ---
    def to_json(self) -> str:
        return json.dumps({
            "name": self.name,
            "features": [
                {"type": f.feat_type.value,
                 "position": [float(v) for v in f.position],
                 "radius": f.radius, "weight": f.weight,
                 **({"posit_projected":
                     [float(v) for v in f.posit_projected]}
                    if f.posit_projected is not None else {}),
                 **({"normal": [float(v) for v in f.normal]}
                    if f.normal is not None else {})}
                for f in self.features],
            "relations": [{"kind": r.kind, "a": r.a, "b": r.b}
                          for r in self.feature_relations],
            "exclusion_spheres": [
                {"center": [float(v) for v in c], "radius": float(r)}
                for c, r in self.exclusion_spheres]})

    @staticmethod
    def from_json(text: str) -> "Pharmacophore":
        d = json.loads(text)
        return Pharmacophore(
            name=d.get("name", ""),
            features=[PharmacophoreFeat(
                feat_type=PharmacophoreFeatType(f["type"]),
                position=np.asarray(f["position"]),
                radius=f.get("radius", 1.5),
                weight=f.get("weight", 1.0),
                posit_projected=(np.asarray(f["posit_projected"])
                                 if "posit_projected" in f else None),
                normal=(np.asarray(f["normal"]) if "normal" in f else None))
                for f in d["features"]],
            feature_relations=[FeatureRelation(r["kind"], r["a"], r["b"])
                               for r in d.get("relations", [])],
            exclusion_spheres=[(np.asarray(s["center"]), s["radius"])
                               for s in d.get("exclusion_spheres", [])])

    # ------------------------------------------------------------------
    def score(self, mol: MoleculeCommon,
              feature_sites=None) -> float:
        return self.score_breakdown(mol, feature_sites).total

    def score_breakdown(self, mol: MoleculeCommon,
                        feature_sites=None) -> PhScreeningScore:
        """Geometric match score in [0, 1] with the reference's semantics
        (pharmacophore.rs:868). `feature_sites` may pre-supply
        `ligand_sites(mol)` output for batch screening."""
        nf = len(self.features)
        if nf == 0:
            return PhScreeningScore(0.0, [], [], 0.0)
        sites = feature_sites if feature_sites is not None \
            else ligand_sites(mol)
        x = np.asarray(mol.positions, float)

        feat_scores = [0.0] * nf
        feat_matched = [False] * nf
        claimed_atoms: set = set()
        claimed_rings: set = set()

        # strength-ordered greedy bijective matching
        order = sorted(range(nf),
                       key=lambda i: -self.features[i].weight)
        for fi in order:
            feat = self.features[fi]
            pool = sites.get(feat.feat_type.site_key, [])
            if not pool:
                continue
            sigma = max(float(feat.radius), 1e-6)
            fdir = feat.direction
            qpos = np.asarray(feat.position, float)
            best, best_idx = 0.0, None
            for si, (spos, catoms, cring, sdir) in enumerate(pool):
                if cring is not None and cring in claimed_rings:
                    continue
                if catoms and any(a in claimed_atoms for a in catoms):
                    continue
                d2 = float(np.sum((qpos - spos) ** 2))
                s = float(np.exp(-0.5 * d2 / (sigma * sigma)))
                if fdir is not None and sdir is not None:
                    if feat.feat_type == PharmacophoreFeatType.AROMATIC:
                        cos_a = abs(float(np.dot(fdir, sdir)))
                    else:
                        cos_a = max(float(np.dot(fdir, sdir)), 0.0)
                    s *= 0.7 + 0.3 * cos_a         # 70% spatial, 30% dir
                if s > best:
                    best, best_idx = s, si
            if best_idx is not None:
                feat_scores[fi] = best
                feat_matched[fi] = best > MATCH_THRESHOLD
                _, catoms, cring, _ = pool[best_idx]
                if cring is not None:
                    claimed_rings.add(cring)
                claimed_atoms.update(catoms)

        # AND / OR relations
        or_suppressed = [False] * nf
        for rel in self.feature_relations:
            if not (0 <= rel.a < nf and 0 <= rel.b < nf):
                continue
            if rel.kind == "or":
                if feat_scores[rel.a] >= feat_scores[rel.b]:
                    or_suppressed[rel.b] = True
                else:
                    or_suppressed[rel.a] = True
            elif rel.kind == "and":
                if not (feat_matched[rel.a] and feat_matched[rel.b]):
                    feat_scores[rel.a] *= 0.5
                    feat_scores[rel.b] *= 0.5

        total_w = w_sum = 0.0
        matched = considered = 0
        for fi, feat in enumerate(self.features):
            if or_suppressed[fi]:
                continue
            w = max(feat.weight, 0.0)
            considered += 1
            total_w += w
            w_sum += w * feat_scores[fi]
            matched += int(feat_matched[fi])
        if total_w <= 0.0 or considered == 0:
            return PhScreeningScore(0.0, feat_scores, feat_matched, 0.0)

        score = w_sum / total_w
        match_frac = matched / considered
        if match_frac < COVERAGE_FLOOR:       # coverage penalty
            score *= match_frac / COVERAGE_FLOOR

        # excluded-volume steric clash penalty (reference :1152-1168)
        clash_frac = 0.0
        if self.exclusion_spheres and len(x):
            inside = np.zeros(len(x), bool)
            for c, r in self.exclusion_spheres:
                inside |= np.sum((x - np.asarray(c, float)) ** 2,
                                 axis=-1) < r * r
            clash_frac = float(inside.mean())
            score *= float(np.clip(1.0 - 2.0 * clash_frac, 0.0, 1.0))

        return PhScreeningScore(float(np.clip(score, 0.0, 1.0)),
                                feat_scores, feat_matched,
                                match_frac, clash_frac)

    def summary(self) -> str:
        """Human-readable summary (reference summary :1198)."""
        counts: dict = {}
        for f in self.features:
            counts[f.feat_type.value] = counts.get(f.feat_type.value, 0) + 1
        parts = [f"{n} {t}" for t, n in sorted(counts.items())]
        rel = f", {len(self.feature_relations)} relations" \
            if self.feature_relations else ""
        exc = f", {len(self.exclusion_spheres)} exclusion spheres" \
            if self.exclusion_spheres else ""
        return f"Pharmacophore '{self.name}': {', '.join(parts)}{rel}{exc}"


# ----------------------------------------------------------------------
def _classify_atoms(mol: MoleculeCommon):
    el = [e.capitalize() for e in mol.elements]
    adj = mol.adjacency()
    x = np.asarray(mol.positions, float)
    fc = mol.formal_charges or [0] * len(el)
    return el, adj, x, fc


def _donor_dir(i, el, adj, x):
    """Heavy atom toward attached H (reference donor_dir :886)."""
    for j in adj[i]:
        if el[j] == "H":
            d = x[j] - x[i]
            n = np.linalg.norm(d)
            if n > 1e-8:
                return d / n
    return None


def _acceptor_dir(i, el, adj, x):
    """Away from heavy-neighbor centroid — lone-pair proxy
    (reference acceptor_dir :904)."""
    heavy = [j for j in adj[i] if el[j] != "H"]
    if not heavy:
        return None
    d = x[i] - np.mean([x[j] for j in heavy], axis=0)
    n = np.linalg.norm(d)
    return d / n if n > 1e-8 else None


def _ring_normal(ring, x):
    pts = x[ring] - x[ring].mean(axis=0)
    _, _, vt = np.linalg.svd(pts, full_matrices=False)
    return vt[-1]


def ligand_sites(mol: MoleculeCommon) -> dict:
    """Candidate ligand sites per feature pool. Each entry:
    (position[3], claim_atom_indices tuple, claim_ring_index|None,
    direction|None) — the claim fields drive bijective matching
    (reference ligand_sites :925-995)."""
    el, adj, x, fc = _classify_atoms(mol)
    out: dict = {k: [] for k in ("donor", "acceptor", "hydrophobic",
                                 "hydrophilic", "aromatic", "positive",
                                 "negative")}
    donors, acceptors = [], []
    for i, e in enumerate(el):
        if e in ("N", "O", "S"):
            if any(el[j] == "H" for j in adj[i]):
                donors.append(i)
            if e in ("N", "O"):
                acceptors.append(i)
        elif e == "C":
            if len(adj[i]) >= 3 and all(el[j] in ("C", "H")
                                        for j in adj[i]):
                out["hydrophobic"].append((x[i], (i,), None, None))
        if fc[i] > 0:
            out["positive"].append((x[i], (i,), None, None))
        elif fc[i] < 0:
            out["negative"].append((x[i], (i,), None, None))
    for i in donors:
        out["donor"].append((x[i], (i,), None, _donor_dir(i, el, adj, x)))
        out["hydrophilic"].append((x[i], (i,), None, None))
    for i in acceptors:
        out["acceptor"].append(
            (x[i], (i,), None, _acceptor_dir(i, el, adj, x)))
        if i not in donors:
            out["hydrophilic"].append((x[i], (i,), None, None))
    char = characterize(mol)
    for ri, ring in enumerate(char.rings):
        if len(ring) in (5, 6):
            out["aromatic"].append((x[ring].mean(axis=0), (), ri,
                                    _ring_normal(ring, x)))
    return out


def hint_sites(feat_type: PharmacophoreFeatType,
               mol: MoleculeCommon) -> List[np.ndarray]:
    """Candidate positions for placing a feature of this type on `mol`
    (reference hint_sites :152)."""
    pool = ligand_sites(mol).get(feat_type.site_key, [])
    return [p for p, _, _, _ in pool]


def extract_feature_sites(mol: MoleculeCommon
                          ) -> List[Tuple[str, np.ndarray]]:
    """Flat (type, position) list — the round-2 surface, kept for the
    screening centroid-alignment prepass."""
    flat = []
    for t, pool in ligand_sites(mol).items():
        if t == "hydrophilic":
            continue
        for p, _, _, _ in pool:
            flat.append((t, p))
    return flat


def auto_pharmacophore(mol: MoleculeCommon, max_features: int = 6,
                       radius: float = 1.5) -> Pharmacophore:
    """Auto candidate pharmacophore from a reference ligand's own features
    (reference new_all_candidates, pharmacophore.rs:651): polar features
    first (weighted up), then aromatics (with ring normals), then
    hydrophobics; sites closer than 2 A to a chosen one are skipped."""
    pools = ligand_sites(mol)
    ranked: List[Tuple[int, str, tuple]] = []
    priority = {"donor": 0, "acceptor": 1, "positive": 0, "negative": 0,
                "aromatic": 2, "hydrophobic": 3}
    for t, pool in pools.items():
        if t == "hydrophilic":
            continue
        for entry in pool:
            ranked.append((priority.get(t, 9), t, entry))
    ranked.sort(key=lambda r: r[0])
    feats: List[PharmacophoreFeat] = []
    for pr, t, (p, _catoms, _cring, sdir) in ranked:
        if len(feats) >= max_features:
            break
        if any(np.linalg.norm(p - f.position) < 2.0 for f in feats):
            continue
        ft = PharmacophoreFeatType(t)
        feats.append(PharmacophoreFeat(
            ft, p, radius=radius,
            weight=1.5 if pr == 0 else 1.0,
            normal=(sdir if ft == PharmacophoreFeatType.AROMATIC
                    else None)))
    return Pharmacophore(features=feats, name=f"auto:{mol.name}")
