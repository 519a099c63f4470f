"""Molecular structure as audio: bonds as diatomic oscillators.

Copy of molchanica_tpu.sonification:
the same host code, so its results equal the reference's bit for bit.

Reference parity: src/sonification.rs — each covalent bond is treated as
a diatomic oscillator (omega = sqrt(k/mu)) and transposed into the
audible range; lighter atoms and stronger/shorter bonds produce higher
tones. Headless form: instead of a live audio sink (rodio), the mixed
waveform is synthesized with numpy and written as a WAV file via the
stdlib — playable anywhere, no audio device required.
"""
from __future__ import annotations

import math
import wave
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .molecules.common import MoleculeCommon
from .molecules.elements import ELEMENT_MASSES

# reference constants (sonification.rs:15-19)
MIN_FREQ_HZ = 80.0
MAX_FREQ_HZ = 5_000.0
VOLUME = 0.08
SAMPLE_RATE = 44_100

# representative harmonic stretch constants by element pair class
# (kcal/mol/A^2, Amber-scale); used when no per-bond k is supplied
_DEFAULT_K = 350.0
_K_BY_PAIR = {
    frozenset(("C", "H")): 340.0, frozenset(("O", "H")): 553.0,
    frozenset(("N", "H")): 434.0, frozenset(("S", "H")): 274.0,
    frozenset(("C", "C")): 310.0, frozenset(("C", "N")): 337.0,
    frozenset(("C", "O")): 320.0, frozenset(("C", "S")): 227.0,
}


@dataclass
class BondTone:
    i: int
    j: int
    freq_hz: float         # audible, transposed
    freq_thz: float        # physical vibrational frequency
    amplitude: float


def bond_tones(mol: MoleculeCommon, k_by_bond: Optional[List[float]] = None,
               include_h: bool = True) -> List[BondTone]:
    """One oscillator per covalent bond: omega = sqrt(k/mu), transposed
    into [MIN_FREQ_HZ, MAX_FREQ_HZ] logarithmically so chemical ordering
    (light atoms / stiff bonds -> higher pitch) is preserved."""
    el = [e.capitalize() for e in mol.elements]
    tones: List[Tuple[int, int, float, float]] = []
    for bi, (i, j) in enumerate(mol.bonds):
        if not include_h and ("H" in (el[i], el[j])):
            continue
        mi = ELEMENT_MASSES.get(el[i], 12.0)
        mj = ELEMENT_MASSES.get(el[j], 12.0)
        mu = mi * mj / (mi + mj)
        k = (k_by_bond[bi] if k_by_bond is not None
             else _K_BY_PAIR.get(frozenset((el[i], el[j])), _DEFAULT_K))
        # omega in sqrt(kcal/mol/A^2 / amu) units; 1 unit = 2.0455e13 rad/s
        omega = math.sqrt(k / mu)
        f_thz = omega * 2.0455e13 / (2 * math.pi) / 1e12
        tones.append((i, j, f_thz, 1.0))
    if not tones:
        return []
    f = np.asarray([t[2] for t in tones])
    lo, hi = float(f.min()), float(f.max())
    span = math.log(hi / lo) if hi > lo * (1 + 1e-9) else 1.0
    out = []
    for (i, j, f_thz, amp) in tones:
        u = math.log(f_thz / lo) / span if span else 0.5
        f_aud = MIN_FREQ_HZ * (MAX_FREQ_HZ / MIN_FREQ_HZ) ** u
        out.append(BondTone(i, j, f_aud, f_thz, amp))
    return out


def synthesize(mol: MoleculeCommon, duration_s: float = 3.0,
               include_h: bool = True,
               k_by_bond: Optional[List[float]] = None,
               sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Mix all bond oscillators into one normalized waveform [-1, 1]."""
    tones = bond_tones(mol, k_by_bond, include_h)
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    if not tones:
        return np.zeros_like(t)
    wavef = np.zeros_like(t)
    for tone in tones:
        wavef += tone.amplitude * np.sin(2 * np.pi * tone.freq_hz * t)
    wavef *= VOLUME / max(len(tones) * 0.05, 1.0)
    peak = np.abs(wavef).max()
    if peak > 1.0:
        wavef /= peak
    # 10 ms fade-in/out to avoid clicks
    n_fade = min(int(0.01 * sample_rate), len(wavef) // 2)
    if n_fade:
        env = np.ones_like(wavef)
        env[:n_fade] = np.linspace(0, 1, n_fade)
        env[-n_fade:] = np.linspace(1, 0, n_fade)
        wavef *= env
    return wavef


def write_wav(path: str, waveform: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> str:
    """Write a mono 16-bit WAV."""
    pcm = (np.clip(waveform, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return path


def sonify_to_file(mol: MoleculeCommon, path: str,
                   duration_s: float = 3.0, include_h: bool = True) -> str:
    """One-call analog of the reference's MoleculeSonification::start."""
    return write_wav(path, synthesize(mol, duration_s, include_h))
