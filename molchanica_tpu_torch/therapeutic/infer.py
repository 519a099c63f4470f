"""Embedded-weights inference (reference infer.rs:53 — batched prediction
from weights shipped inside the package).

Port of molchanica_tpu.therapeutic.infer. A target's weights are the
port's own file (weights/<target>.pt, written by train_target) when there
is one, else the JAX package's committed pickle, read in place without JAX
(models.adme.load_reference_pickle). The network runs on the card unless
device="cpu".
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.adme import (adme_forward, build_model, featurize_batch,
                           load_weights, postprocess)
from .targets import EXPERIMENTAL_DATA, REFERENCE_DIR
from .train import WEIGHTS_DIR

REFERENCE_WEIGHTS_DIR = os.path.join(REFERENCE_DIR, "weights")
# searched in this order
_WEIGHTS = ((WEIGHTS_DIR, ".pt"), (REFERENCE_WEIGHTS_DIR, ".pkl"))


def weights_file(target: str) -> Optional[str]:
    """The file TherapeuticPredictor(target) loads, or None."""
    for d, ext in _WEIGHTS:
        path = os.path.join(d, target + ext)
        if os.path.exists(path):
            return path
    return None


class TherapeuticPredictor:
    """Loads a trained target model and predicts from SMILES/molecules.

    Featurization is host numpy per molecule; the network is one batched
    forward on the predictor's device.
    """

    def __init__(self, target: str, weights_path: Optional[str] = None,
                 device=None):
        path = weights_path or weights_file(target)
        if path is None or not os.path.exists(path):
            raise FileNotFoundError(
                f"no trained weights for {target!r} in {WEIGHTS_DIR} or "
                f"{REFERENCE_WEIGHTS_DIR}; run "
                "molchanica_tpu_torch.therapeutic.train_target first")
        blob = load_weights(path)
        self.weights_path = path
        self.target = blob["target"]
        self.scaler = blob["scaler"]
        self.cfg = blob["cfg"]
        self.model = build_model(self.cfg, blob["state_dict"], device)
        self.metrics: Dict[str, float] = blob.get("metrics", {})
        # honest provenance: measured experimental labels vs computed
        # physicochemical surrogates (see targets.EXPERIMENTAL_DATA)
        self.label_source = ("measured"
                             if self.target in EXPERIMENTAL_DATA
                             else "computed-proxy")

    def raw_feats(self, feats) -> np.ndarray:
        """The network's raw outputs (logits or scaled values) on stacked
        featurize_batch arrays."""
        return adme_forward(self.model, feats)

    def predict_mols(self, mols) -> np.ndarray:
        return np.asarray(postprocess(self.raw_feats(featurize_batch(mols)),
                                      self.scaler, self.cfg))

    def predict(self, smiles: Sequence[str]) -> np.ndarray:
        from ..molecules.smiles import from_smiles

        return self.predict_mols([from_smiles(s) for s in smiles])

    @staticmethod
    def available() -> List[str]:
        names = set()
        for d, ext in _WEIGHTS:
            if os.path.isdir(d):
                names.update(p[:-len(ext)] for p in os.listdir(d)
                             if p.endswith(ext))
        return sorted(names)


# ---------------------------------------------------------------------
# Grouped property orchestration (reference therapeutic/mod.rs:273-345:
# TherapeuticProperties { adme, toxicity } filled by per-target inference)

from dataclasses import dataclass, field, fields  # noqa: E402

# target name -> (group, field)
_FIELD_MAP = {
    "caco2_wang": ("adme", "intestinal_permeability"),
    "hia_hou": ("adme", "intestinal_absorption"),
    "pgp_broccatelli": ("adme", "pgp"),
    "bioavailability_ma": ("adme", "oral_bioavailability"),
    "lipophilicity_astrazeneca": ("adme", "lipophilicity"),
    "logp_experimental": ("adme", "logp"),
    "solubility_aqsoldb": ("adme", "solubility_water"),
    "pampa_ncats": ("adme", "membrane_permeability"),
    "hydrationfreeenergy_freesolv": ("adme", "hydration_free_energy"),
    "bbb_martins": ("adme", "blood_brain_barrier"),
    "ppbr_az": ("adme", "plasma_protein_binding_rate"),
    "vdss_lombardo": ("adme", "vdss"),
    "cyp2c19_veith": ("adme", "cyp_2c19_inhibition"),
    "cyp2d6_veith": ("adme", "cyp_2d6_inhibition"),
    "cyp3a4_veith": ("adme", "cyp_3a4_inhibition"),
    "cyp1a2_veith": ("adme", "cyp_1a2_inhibition"),
    "cyp2c9_veith": ("adme", "cyp_2c9_inhibition"),
    "half_life_obach": ("adme", "half_life"),
    "clearance_hepatocyte_az": ("adme", "clearance"),
    "ld50_zhu": ("toxicity", "ld50"),
    "herg": ("toxicity", "ether_a_go_go"),
    "ames": ("toxicity", "mutagenicity"),
    "dili": ("toxicity", "drug_induced_liver_injury"),
    "skin_reaction": ("toxicity", "skin_reaction"),
    "carcinogens_lagunin": ("toxicity", "carcinogen"),
}

_NAN = float("nan")


@dataclass
class Adme:
    """Absorption / distribution / metabolism / excretion estimates
    (reference Adme, mod.rs:273)."""
    intestinal_permeability: float = _NAN
    intestinal_absorption: float = _NAN
    pgp: float = _NAN
    oral_bioavailability: float = _NAN
    lipophilicity: float = _NAN
    logp: float = _NAN
    solubility_water: float = _NAN
    membrane_permeability: float = _NAN
    hydration_free_energy: float = _NAN
    blood_brain_barrier: float = _NAN
    plasma_protein_binding_rate: float = _NAN
    vdss: float = _NAN
    cyp_2c19_inhibition: float = _NAN
    cyp_2d6_inhibition: float = _NAN
    cyp_3a4_inhibition: float = _NAN
    cyp_1a2_inhibition: float = _NAN
    cyp_2c9_inhibition: float = _NAN
    half_life: float = _NAN
    clearance: float = _NAN


@dataclass
class Toxicity:
    """Toxicity estimates (reference Toxicity, mod.rs:327)."""
    ld50: float = _NAN
    ether_a_go_go: float = _NAN
    mutagenicity: float = _NAN
    drug_induced_liver_injury: float = _NAN
    skin_reaction: float = _NAN
    carcinogen: float = _NAN


@dataclass
class TherapeuticProperties:
    """Grouped per-molecule estimates (reference TherapeuticProperties,
    mod.rs:345). Fields without trained weights stay NaN."""
    adme: Adme = field(default_factory=Adme)
    toxicity: Toxicity = field(default_factory=Toxicity)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            "adme": {f.name: getattr(self.adme, f.name)
                     for f in fields(Adme)},
            "toxicity": {f.name: getattr(self.toxicity, f.name)
                         for f in fields(Toxicity)},
        }


def compute_therapeutic_properties(
        smiles_list: Sequence[str],
        targets: Optional[Sequence[str]] = None, device=None
) -> List[TherapeuticProperties]:
    """Run every available trained target over a batch of molecules and
    assemble grouped property objects — the reference's per-target
    orchestration (mod.rs:423-470), batched: one inference pass per
    TARGET over all molecules (not one per molecule)."""
    from ..molecules.smiles import from_smiles

    mols = [from_smiles(s) for s in smiles_list]
    avail = set(TherapeuticPredictor.available())
    wanted = [t for t in (targets or sorted(_FIELD_MAP)) if t in avail]
    out = [TherapeuticProperties() for _ in mols]
    for t in wanted:
        group_field = _FIELD_MAP.get(t)
        if group_field is None:
            continue
        group, fname = group_field
        vals = TherapeuticPredictor(t, device=device).predict_mols(mols)
        for props, v in zip(out, vals):
            setattr(getattr(props, group), fname, float(v))
    return out
