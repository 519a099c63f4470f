"""Mid-run MD checkpoint/resume (port of molchanica_tpu.md.checkpoint).

The full dynamic state — positions, velocities, box, the random
generator's state, step count, coupling and the last energies —
round-trips through one npz file, so a run resumes bit-exactly (the same
random stream) on the sim's own device. The JAX package saves its PRNG
key (`rng_key`) where this one saves the torch.Generator's state
(`generator_state`); a JAX-written file cannot seed the same stream, so
`load_checkpoint` refuses it rather than reseeding.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .engine import MdSim
from .state import MdState

_FORMAT_VERSION = 1


def _host(t):
    return t.detach().cpu().numpy()


def save_checkpoint(path, sim: MdSim, extra: dict = None):
    s = sim.state
    gen = s.generator
    meta = dict(
        version=_FORMAT_VERSION,
        method=sim.method,
        n_constraints=sim.n_constraints,
        wall_time=sim.computation_time(),
        generator_device=gen.device.type,
        extra=extra or {},
    )
    np.savez_compressed(
        path,
        positions=_host(s.positions),
        velocities=_host(s.velocities),
        box=(np.zeros(0) if s.box is None else _host(s.box)),
        step=np.asarray(s.step),
        generator_state=gen.get_state().numpy(),
        couple=_host(s.couple),
        pe_last=_host(s.pe_last),
        ke_last=_host(s.ke_last),
        dhdl_last=_host(s.dhdl_last),
        meta=json.dumps(meta),
    )
    return path


def load_checkpoint(path, sim: MdSim) -> MdSim:
    """Restore dynamic state into an MdSim built with the same topology/cfg,
    on its device; the generator state goes into the sim's own generator.
    Raises ValueError for an unknown format version, a file of the JAX
    package (an rng_key, no generator state) or a generator saved on
    another device type."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} unsupported")
    if "generator_state" not in z.files:
        if "rng_key" in z.files:
            raise ValueError(
                f"{path} was written by the JAX package: it holds a JAX "
                "PRNG key (rng_key) and no torch generator state, so the "
                "run cannot resume bit for bit; refusing to reseed")
        raise ValueError(f"{path} holds no generator state")
    gen = sim.state.generator
    if meta.get("generator_device") != gen.device.type:
        raise ValueError(
            f"checkpoint generator saved on {meta.get('generator_device')!r}"
            f", the sim's is on {gen.device.type!r}: its random stream "
            "cannot be restored there")
    gen.set_state(torch.from_numpy(np.array(z["generator_state"])))
    dtype, dev = sim.dtype, sim.device

    def t(name):
        return torch.as_tensor(np.array(z[name]), dtype=dtype, device=dev)

    sim.state = MdState(
        positions=t("positions"),
        velocities=t("velocities"),
        box=None if z["box"].size == 0 else t("box"),
        step=int(z["step"]),
        generator=gen,
        couple=t("couple"),
        pe_last=t("pe_last"),
        ke_last=t("ke_last"),
        dhdl_last=t("dhdl_last"),
    )
    sim._wall_time = float(meta.get("wall_time", 0.0))
    return sim
