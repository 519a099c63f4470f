"""Antibody tools: chain numbering + CDR identification.

Copy of molchanica_tpu.antibody:
the same host code, so its results equal the reference's bit for bit.

Reference parity: the ANARCI / IgBLAST adapters in src/external_tools/
{anarcii,igblast}.rs. When the external tools are installed (see
external_tools.probe) they are invoked; otherwise a built-in
anchor-residue heuristic identifies the CDR loops directly (the
Chothia-style conserved anchors: Cys22/Cys92, the W of the FR4 WG.G
motif, heavy-chain CDR boundaries from the canonical positions).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .external_tools import probe, run_tool


@dataclass
class CdrAnnotation:
    chain_type: str                   # "H" | "L" | "?"
    cdr1: Tuple[int, int]             # [start, end) residue indices
    cdr2: Tuple[int, int]
    cdr3: Tuple[int, int]
    source: str                       # "anarci" | "heuristic"

    def loops(self, seq: str) -> Dict[str, str]:
        return {"CDR1": seq[slice(*self.cdr1)],
                "CDR2": seq[slice(*self.cdr2)],
                "CDR3": seq[slice(*self.cdr3)]}


def _heuristic_annotate(seq: str) -> CdrAnnotation:
    """Anchor-based CDR identification (Chothia-flavoured).

    - first conserved Cys ~pos 22 and second conserved Cys ~pos 88-96
      frame the variable domain
    - CDR3 runs from 3 after the second Cys to before the FR4 W(GQ)G motif
    - CDR1 follows the first Cys (+1..+11-ish, bounded by the conserved
      W at ~pos 36); CDR2 sits ~15 after CDR1's end
    """
    s = seq.upper()
    cys = [m.start() for m in re.finditer("C", s)]
    if len(cys) < 2:
        raise ValueError("no conserved cysteine pair found")
    c1 = min(cys, key=lambda i: abs(i - 22))
    c2 = min((c for c in cys if c > c1 + 40), default=None,
             key=lambda i: abs(i - 92)) if any(c > c1 + 40 for c in cys) \
        else None
    if c2 is None:
        raise ValueError("second conserved cysteine not found")
    # FR4 anchor: W.G motif after c2 (WGQG / WGGG heavy, FGGG-like light)
    m = re.search(r"[WF]G.G", s[c2:])
    fr4 = c2 + m.start() if m else min(len(s), c2 + 14)
    # chain type guess: heavy CDR3s follow 'AR'/'AK' after c2
    heavy = bool(re.match(r".{1,3}[AR][RK]", s[c2:c2 + 6])) or \
        (m and s[c2 + m.start()] == "W")
    cdr3 = (c2 + 3, fr4)
    # CDR1: after c1 up to the conserved W (~c1+14)
    w1 = s.find("W", c1 + 4, c1 + 20)
    cdr1 = (c1 + 4, w1 if w1 > 0 else c1 + 14)
    # CDR2: ~15 residues after CDR1 end, length ~8
    start2 = (cdr1[1] + 14)
    cdr2 = (start2, min(start2 + 8, cdr3[0] - 10 if cdr3[0] - 10 > start2
                        else start2 + 8))
    return CdrAnnotation(chain_type="H" if heavy else "L",
                         cdr1=cdr1, cdr2=cdr2, cdr3=cdr3,
                         source="heuristic")


def annotate_cdrs(seq: str, prefer_external: bool = True) -> CdrAnnotation:
    """CDR annotation via ANARCI when installed, else the heuristic."""
    if prefer_external and probe("anarci").available:
        try:
            r = run_tool("anarci", ["-i", seq, "--scheme", "chothia"])
            ann = _parse_anarci(r.stdout, seq)
            if ann is not None:
                return ann
        except Exception:
            pass
    return _heuristic_annotate(seq)


def _parse_anarci(out: str, seq: str) -> Optional[CdrAnnotation]:
    """Minimal ANARCI table parse -> Chothia CDR windows."""
    rows = []
    chain = "?"
    for ln in out.splitlines():
        m = re.match(r"^([HL])\s+(\d+)\s*([A-Z]?)\s+([A-Z\-])", ln)
        if m:
            chain = m.group(1)
            rows.append((int(m.group(2)), m.group(4)))
    if not rows:
        return None
    # Chothia CDR windows by number
    windows = {"H": ((26, 32), (52, 56), (95, 102)),
               "L": ((24, 34), (50, 56), (89, 97))}[chain]
    idx = 0
    spans = []
    for lo, hi in windows:
        start = end = None
        pos = 0
        idx = 0
        for num, aa in rows:
            if aa == "-":
                continue
            if lo <= num <= hi:
                if start is None:
                    start = idx
                end = idx + 1
            idx += 1
        spans.append((start or 0, end or 0))
    return CdrAnnotation(chain_type=chain, cdr1=spans[0], cdr2=spans[1],
                         cdr3=spans[2], source="anarci")


def humanness_flags(seq: str) -> Dict[str, bool]:
    """Quick liability flags over the CDRs (deamidation NG/NS,
    isomerization DG, unpaired Cys, N-glycosylation NxS/T)."""
    ann = annotate_cdrs(seq)
    loops = ann.loops(seq)
    cdrs = "".join(loops.values())
    return {
        "deamidation_NG": "NG" in cdrs or "NS" in cdrs,
        "isomerization_DG": "DG" in cdrs,
        "glycosylation_NxS/T": bool(re.search(r"N[^P][ST]", seq)),
        "unpaired_cys": seq.count("C") % 2 == 1,
    }
