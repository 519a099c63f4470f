"""DockingSetup: one-time receptor precompute for batched pose scoring
(port of molchanica_tpu.docking.setup).

Reference: src/docking/legacy/prep.rs:26-52 — receptor atoms culled to the
site neighborhood, flattened per-pair LJ parameters, hydrophobic mask,
H-bond donor/acceptor classification. Here the fixed-shape padded arrays
are made in numpy float32 exactly as the reference makes them, and held as
tensors on the device the scorer runs on.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .site import DockingSite

_RMIN_TO_SIGMA = 2.0 / 2.0 ** (1.0 / 6.0)

TENSOR_FIELDS = ("rec_pos", "rec_q", "rec_sigma", "rec_eps", "rec_mask",
                 "rec_donor", "rec_acceptor", "rec_hydrophobic")


@dataclass
class DockingSetup:
    rec_pos: torch.Tensor       # [R, 3] site-local receptor atoms (padded)
    rec_q: torch.Tensor         # [R]
    rec_sigma: torch.Tensor     # [R]
    rec_eps: torch.Tensor       # [R]
    rec_mask: torch.Tensor      # [R]
    rec_donor: torch.Tensor     # [R] polar H (H-bond donor hydrogen)
    rec_acceptor: torch.Tensor  # [R] N/O acceptor
    rec_hydrophobic: torch.Tensor  # [R] apolar carbon
    site: DockingSite
    n_rec_real: int

    @property
    def device(self) -> torch.device:
        return self.rec_pos.device

    def to(self, device) -> "DockingSetup":
        """The same setup with its tensors on `device`."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in TENSOR_FIELDS})

    @staticmethod
    def new(receptor_spec, site: DockingSite, margin: float = 6.0,
            pad_to_multiple: int = 256, elements=None, device=None):
        """Cull receptor atoms within site_radius + margin of the center.

        receptor_spec: a MolSpec (or anything with positions/charges/
        lj_sigma/lj_eps); `elements` enables donor/acceptor/hydrophobic
        classification (falls back to eps/charge heuristics without it).
        The tensors go to `device` (None: the CUDA card).
        """
        dev = resolve_device(device)
        pos = np.asarray(receptor_spec.positions)
        center = np.asarray(site.site_center)
        r = np.linalg.norm(pos - center, axis=1)
        keep = np.where(r < site.site_radius + margin)[0]
        n = len(keep)
        pad = max(pad_to_multiple,
                  int(math.ceil(n / pad_to_multiple)) * pad_to_multiple)

        def padded(a, fill=0.0):
            out = np.full(pad, fill, np.float32)
            out[:n] = np.asarray(a)[keep]
            return out

        pos_p = np.zeros((pad, 3), np.float32)
        pos_p[:n] = pos[keep]
        pos_p[n:] = 1e4
        q = padded(receptor_spec.charges)
        sig = padded(receptor_spec.lj_sigma, 1.0)
        eps = padded(receptor_spec.lj_eps)
        mask = np.zeros(pad, np.float32)
        mask[:n] = 1.0

        # donor/acceptor/hydrophobic classification
        donor = np.zeros(pad, np.float32)
        acceptor = np.zeros(pad, np.float32)
        hydrophobic = np.zeros(pad, np.float32)
        if elements is not None:
            el = [elements[i].capitalize() for i in keep]
            qk = np.asarray(receptor_spec.charges)[keep]
            for i, e in enumerate(el):
                if e == "H" and qk[i] > 0.25:
                    donor[i] = 1.0
                elif e in ("N", "O"):
                    acceptor[i] = 1.0
                elif e == "C" and abs(qk[i]) < 0.2:
                    hydrophobic[i] = 1.0
        else:
            qk = np.asarray(receptor_spec.charges)[keep]
            mk = np.asarray(receptor_spec.masses)[keep]
            donor[:n] = (mk < 2.0) & (qk > 0.25)
            acceptor[:n] = (mk > 13.0) & (mk < 17.5) & (qk < -0.3)
            hydrophobic[:n] = (np.abs(qk) < 0.2) & (mk > 11.0) & (mk < 13.0)

        def t(a):
            return torch.as_tensor(a, device=dev)

        return DockingSetup(
            rec_pos=t(pos_p), rec_q=t(q), rec_sigma=t(sig), rec_eps=t(eps),
            rec_mask=t(mask), rec_donor=t(donor), rec_acceptor=t(acceptor),
            rec_hydrophobic=t(hydrophobic), site=site, n_rec_real=n)
