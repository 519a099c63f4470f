"""Therapeutic target registry.

Reference parity: the 24 TDC ADMET targets enumerated in
src/therapeutic/mod.rs:56-80 (caco2_wang, hia_hou,
bioavailability_ma, lipophilicity_astrazeneca, solubility_aqsoldb, ...).
Each TargetSpec carries the task name, type (regression/classification),
and a label source. With no network access the built-in label source
computes real physicochemical properties via molecules/characterization
(documented per target); dropping the actual TDC CSV into
`train_target(..., csv=...)` trains on measured data with the same code.

Copy of molchanica_tpu.therapeutic.targets:
the same host code, so its labels equal the reference's bit for bit. The
CSVs of EXPERIMENTAL_DATA are the committed ones under
molchanica_tpu/therapeutic/ (``REFERENCE_DIR``), read by path.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

# the reference package's therapeutic/ directory: EXPERIMENTAL_DATA's CSVs
# and the committed weights, read in place
REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "molchanica_tpu", "therapeutic")


@dataclass(frozen=True)
class TargetSpec:
    name: str
    classification: bool
    label_fn: Callable            # (MolCharacterization, MoleculeCommon) -> float
    description: str = ""


def _clogp(ch, mol):
    return ch.clogp


def _tpsa(ch, mol):
    return ch.tpsa


def _solubility_proxy(ch, mol):
    # ESOL-style: logS ~ 0.16 - 0.63 logP - 0.0062 MW + 0.066 RB - 0.74 AP
    ap = 6.0 * ch.n_aromatic_rings / max(ch.n_heavy, 1)
    return (0.16 - 0.63 * ch.clogp - 0.0062 * ch.mol_weight
            + 0.066 * len(ch.rotatable_bonds) - 0.74 * ap)


def _permeability_proxy(ch, mol):
    # Caco-2-style: falls with TPSA and HBD, rises with logP (bounded)
    return (-4.0 - 0.011 * ch.tpsa - 0.2 * ch.h_bond_donors
            + 0.15 * min(ch.clogp, 4.0))


def _hia_class(ch, mol):
    # Veber-style absorbed/not-absorbed (thresholds chosen so both classes
    # are populated on drug-like sets: strict TPSA + flexibility gate)
    return 1.0 if (ch.tpsa < 28.0 and ch.clogp > 1.0) else 0.0


def _bbb_class(ch, mol):
    return 1.0 if (ch.tpsa < 90.0 and 1.0 < ch.clogp < 4.0
                   and ch.mol_weight < 450) else 0.0


def _half_life_proxy(ch, mol):
    return math.log1p(ch.mol_weight) - 0.3 * len(ch.rotatable_bonds) \
        + 0.5 * len(ch.rings)


def _clearance_proxy(ch, mol):
    return 2.0 + 0.4 * ch.clogp - 0.01 * ch.tpsa


def _ppbr_proxy(ch, mol):
    # plasma protein binding rises with lipophilicity + aromatics
    return min(99.0, 45.0 + 12.0 * min(ch.clogp, 5.0)
               + 4.0 * ch.n_aromatic_rings - 0.1 * ch.tpsa)


def _vdss_proxy(ch, mol):
    # log VDss grows with lipophilicity + basic amines, falls with TPSA
    return (-0.4 + 0.25 * ch.clogp
            + 0.4 * ch.functional_groups.amine - 0.005 * ch.tpsa)


def _ld50_proxy(ch, mol):
    # log(1/LD50)-style toxicity proxy: reactive/halogenated/large
    return (1.8 + 0.1 * ch.clogp + 0.08 * ch.functional_groups.halogen
            + 0.15 * ch.functional_groups.nitro)


def _fu_hydration_proxy(ch, mol):
    # FreeSolv-style hydration dG: polar groups solvate, hydrophobes don't
    return (-2.0 - 0.35 * ch.tpsa / 10.0 - 1.2 * ch.h_bond_donors
            + 0.9 * min(ch.clogp, 6.0))


def _pampa_class(ch, mol):
    # thresholds sit inside the builtin set's descriptor range so both
    # classes are populated (the TDC rule-of-thumb tpsa<100 never fires
    # on small fragments)
    return 1.0 if (ch.tpsa < 30.0 and ch.clogp > 0.5) else 0.0


def _pgp_class(ch, mol):
    # size+polarity trend of P-gp substrates, thresholded inside the
    # builtin set's range so the class split is non-degenerate
    return 1.0 if (ch.mol_weight > 160 and ch.h_bond_acceptors >= 3) \
        else 0.0


def _cyp_class(thresh_logp, thresh_arom):
    def f(ch, mol):
        return 1.0 if (ch.clogp > thresh_logp
                       and ch.n_aromatic_rings >= thresh_arom) else 0.0
    return f


def _ames_class(ch, mol):
    fg = ch.functional_groups
    return 1.0 if (fg.nitro > 0 or (fg.amine > 0
                                    and ch.n_aromatic_rings >= 2)) else 0.0


def _dili_class(ch, mol):
    # lipophilicity-driven hepatotoxicity trend, thresholded inside the
    # builtin set's MW range (<=240) so both classes are populated
    return 1.0 if (ch.clogp > 2.5 and ch.mol_weight > 150) else 0.0


def _herg_class(ch, mol):
    # basic-amine + lipophilicity hERG pharmacophore trend (threshold
    # inside the builtin set's clogp range)
    fg = ch.functional_groups
    return 1.0 if (ch.clogp > 1.5 and fg.amine > 0) else 0.0


def _carcinogen_class(ch, mol):
    # structural-alert census: nitro/halogen load or fused aromatics
    fg = ch.functional_groups
    return 1.0 if (fg.nitro + fg.halogen >= 1
                   or ch.n_aromatic_rings >= 2) else 0.0


def _skin_class(ch, mol):
    fg = ch.functional_groups
    return 1.0 if (fg.carbonyl + fg.ester > 0 and ch.mol_weight < 250) \
        else 0.0


def _bioavail_class(ch, mol):
    # Lipinski-ish gate tightened to discriminate within small fragments
    # (everything in the builtin set passes the classic rule-of-5)
    return 1.0 if (ch.h_bond_donors <= 1 and ch.tpsa < 45.0
                   and ch.clogp < 4.0) else 0.0


# Full 24-dataset TDC registry (reference DatasetTdc enum,
# therapeutic/mod.rs:56-80). Labels here are COMPUTED physicochemical
# proxies unless the target appears in EXPERIMENTAL_DATA below — proxies
# exercise the training/inference plumbing and give qualitatively sane
# trends, but are NOT measured ADMET data; drop the TDC CSV into
# train_target(csv=...) for real labels.
_REG = [
    ("lipophilicity_astrazeneca", _clogp, "octanol-water logD proxy"),
    ("tpsa_surrogate", _tpsa, "topological polar surface area"),
    ("solubility_aqsoldb", _solubility_proxy, "ESOL-style logS"),
    ("caco2_wang", _permeability_proxy, "membrane permeability proxy"),
    ("half_life_obach", _half_life_proxy, "half-life proxy"),
    ("clearance_hepatocyte_az", _clearance_proxy, "clearance proxy"),
    ("ppbr_az", _ppbr_proxy, "plasma protein binding %, proxy"),
    ("vdss_lombardo", _vdss_proxy, "log VDss proxy"),
    ("ld50_zhu", _ld50_proxy, "acute toxicity proxy"),
    ("hydrationfreeenergy_freesolv", _fu_hydration_proxy,
     "hydration dG proxy (run_sol_sim computes the real thing)"),
]
_CLS = [
    ("hia_hou", _hia_class, "human intestinal absorption"),
    ("bbb_martins", _bbb_class, "blood-brain-barrier penetration"),
    ("pampa_ncats", _pampa_class, "PAMPA permeability class"),
    ("pgp_broccatelli", _pgp_class, "P-gp substrate class"),
    ("cyp1a2_veith", _cyp_class(2.0, 2), "CYP1A2 inhibition proxy"),
    ("cyp2c9_veith", _cyp_class(2.5, 1), "CYP2C9 inhibition proxy"),
    ("cyp2c19_veith", _cyp_class(2.2, 1), "CYP2C19 inhibition proxy"),
    ("cyp2d6_veith", _cyp_class(2.8, 1), "CYP2D6 inhibition proxy"),
    ("cyp3a4_veith", _cyp_class(3.0, 2), "CYP3A4 inhibition proxy"),
    ("ames", _ames_class, "Ames mutagenicity structural-alert proxy"),
    ("dili", _dili_class, "drug-induced liver injury proxy"),
    ("herg", _herg_class, "hERG blocker proxy"),
    ("carcinogens_lagunin", _carcinogen_class, "carcinogenicity proxy"),
    ("skin_reaction", _skin_class, "skin reaction proxy"),
    ("bioavailability_ma", _bioavail_class, "oral bioavailability class"),
]

TARGETS: Dict[str, TargetSpec] = {}
for _n, _f, _d in _REG:
    TARGETS[_n] = TargetSpec(_n, False, _f, _d)
for _n, _f, _d in _CLS:
    TARGETS[_n] = TargetSpec(_n, True, _f, _d)

# --- measured-data targets -------------------------------------------------
# EXPERIMENTAL labels shipped with the package (no network needed): maps
# target name -> CSV relative to this module. logp_experimental is ~100
# compounds with literature octanol/water logP (Hansch-Leo-compilation
# standard values) — features come from structure, labels from MEASUREMENT,
# so the model is predicting something its featurizer does not compute
# (unlike the proxy targets above, which are honest plumbing tests only).
EXPERIMENTAL_DATA: Dict[str, str] = {
    "logp_experimental": "data/logp_experimental.csv",
    # experimental hydration free energies (kcal/mol) for ~90 small
    # molecules — classic literature values of the kind FreeSolv
    # curates; the TDC HydrationFreeEnergy_FreeSolv target trains on
    # measured data here, not a computed surrogate
    "hydrationfreeenergy_freesolv": "data/freesolv_experimental.csv",
    # measured aqueous solubility (log10 mol/L, 25 C): 59 standard
    # literature/handbook values (alkanes through drugs: DDT -8.08,
    # naproxen -4.15, caffeine -0.88, ...) — the TDC Solubility_AqSolDB
    # target now trains on MEASURED data by default instead of the
    # ESOL-formula surrogate
    "solubility_aqsoldb": "data/solubility_experimental.csv",
    # measured acidic pKa (water, 25 C): 40 textbook values (carboxylic
    # acids, phenols, barbiturates); labels a featurizer cannot compute
    "pka_experimental": "data/pka_experimental.csv",
    # measured logD7.4 (octanol/water at pH 7.4): 50 literature values
    # (acids at their ionization-corrected logD, neutrals at logP) — the
    # TDC Lipophilicity_AstraZeneca target trains on MEASURED labels by
    # default instead of the cLogP surrogate
    "lipophilicity_astrazeneca": "data/lipophilicity_experimental.csv",
    # blood-brain-barrier penetration (1/0): 38 curated literature labels
    # (CNS drugs/anesthetics vs known non-penetrants) — the TDC
    # BBB_Martins classification target on measured labels
    "bbb_martins": "data/bbb_experimental.csv",
    # measured Caco-2 apparent permeability log10(Papp, cm/s), A->B
    # monolayer assay: 40 drugs with literature values of the kind the
    # Hou/Wang compilations curate (propranolol -4.38 ... mannitol -6.42);
    # inter-lab spread on this assay is ~0.3 log units — the TDC
    # Caco2_Wang target trains on MEASURED labels by default instead of
    # the TPSA/HBD permeability surrogate
    "caco2_wang": "data/caco2_experimental.csv",
    # human intestinal absorption class (1 = HIA >= 30%, the Hou-dataset
    # convention): 44 drugs with documented absorbed fractions — orally
    # absorbed drugs vs the classic non-absorbed set (mannitol,
    # bisphosphonates, foscarnet, ganciclovir, sulfasalazine, ...);
    # the TDC HIA_Hou classification target on measured labels
    "hia_hou": "data/hia_experimental.csv",
    # measured human plasma protein binding (% bound): 40 drugs with
    # standard pharmacology-reference values (warfarin 99, digoxin-class
    # lows, metformin ~0) — the TDC PPBR_AZ regression target trains on
    # MEASURED labels by default instead of the logP-based proxy
    "ppbr_az": "data/ppbr_experimental.csv",
    # measured elimination half-life, log10(hours): 41 drugs with
    # standard clinical-PK values (phenobarbital ~99 h ... amoxicillin
    # ~1 h) — the TDC Half_Life_Obach regression target on measured
    # labels instead of the MW/rotor count proxy
    "half_life_obach": "data/half_life_experimental.csv",
}
TARGETS["logp_experimental"] = TargetSpec(
    "logp_experimental", False, _clogp,
    "experimental octanol/water logP (embedded literature dataset)")
TARGETS["pka_experimental"] = TargetSpec(
    "pka_experimental", False, lambda ch, mol: 7.0,   # labels come from CSV
    "experimental acidic pKa (embedded literature dataset)")


def compute_labels(spec: TargetSpec, mols) -> np.ndarray:
    from ..molecules.characterization import characterize

    out = []
    for m in mols:
        ch = characterize(m)
        out.append(float(spec.label_fn(ch, m)))
    return np.asarray(out)
