"""One run of one cell: set-up, the measured window, the traced readings and
the check, on the device it is given (the card; the CPU only in the
benchmark's own tests)."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import cells, check, trace
from .reference.physics import ACCEL, KB, System

FORBIDDEN = ("jax", "jaxlib", "flax", "molchanica_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's (compared whole: molchanica_tpu_torch is not
    molchanica_tpu)."""
    import sys
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def seeds(seed: int):
    """Two independent 63-bit seeds from --seed: the velocities' and the
    farm's (its Langevin noise)."""
    s = np.random.SeedSequence(seed & (2 ** 64 - 1)).generate_state(
        2, dtype=np.uint64)
    return int(s[0] >> np.uint64(1)), int(s[1] >> np.uint64(1))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """A cell on a device: its parts, the program's objects and what was
    measured."""

    def __init__(self, root, cell, seed, device, bench=None):
        self.root = root
        self.device = torch.device(device)
        bench = bench if bench is not None else cells.load_bench(root)
        self.bench = bench
        self.cell = cells.workload(bench, cell)
        self.config = cells.load_config(self.cell["config"], root)
        self.traffic = cells.load_traffic(self.cell["traffic"], root)
        self.seed = seed
        self.replicas = int(self.traffic["replicas"])
        self.dt = float(self.traffic["dt_ps"])
        self.k = int(self.traffic["steps_per_call"])
        self.split = {}
        self.sim = self.farm = None

    def _lap(self, key, t0):
        sync(self.device)
        t = time.perf_counter()
        self.split[key] = self.split.get(key, 0.0) + (t - t0)
        return t

    def setup(self):
        """Build the program's MdSim and ReplicaFarm from the data files,
        draw the velocities and warm the cell's shapes up."""
        t = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        from molchanica_tpu_torch.md.engine import MdSim
        import molchanica_tpu_torch.parallel.replicas  # noqa: F401
        t = self._lap("imports", t)
        arrays, statics, box, x0 = cells.load_system(self.config, self.root)
        self.arrays, self.statics, self.box = arrays, statics, box
        md_cfg = cells.md_config(self.config["md"])
        top = cells.topology(arrays, statics, self.device)
        t = self._lap("data", t)
        if md_cfg.use_pallas and self.device.type == "cuda":
            from molchanica_tpu_torch import cuda_build
            cuda_build.load_library()
            t = self._lap("nvcc", t)
        sim = MdSim(top, md_cfg, x0, box_extent=box,
                    method=self.config["method"], device=self.device)
        scale = self.config.get("cluster_list_scale")
        if scale is not None:
            # the cluster-list width MdSim.step replans to after an
            # overflow; the farm raises on one instead
            sim._m_scale = float(scale)
            sim.rebuild_neighbor_plan()
        if sim._nbr_backend != self.config["backend"]:
            raise RuntimeError(f"direct-space backend {sim._nbr_backend}, "
                               f"the configuration states "
                               f"{self.config['backend']}")
        self.sim = sim
        self._lap("build", t)
        self.start(self.seed)

    def start(self, seed):
        """A fresh farm on the built MdSim: velocities and Langevin noise
        from `seed`, then the warm-up calls (the cell's shapes only)."""
        from molchanica_tpu_torch.parallel.replicas import ReplicaFarm

        t = time.perf_counter()
        self.seed = seed
        v_seed, farm_seed = seeds(seed)
        self.farm = ReplicaFarm(self.sim, self.replicas, seed=farm_seed)
        self.farm._chunks[0].v = self._velocities(self.sim, v_seed)
        for _ in range(int(self.traffic["warmup_calls"])):
            self.farm.step(self.dt, self.k)
        self._lap("warmup", t)

    def _velocities(self, sim, seed):
        """[R, N, 3] Maxwell-Boltzmann velocities at the target temperature
        from `seed`, each replica's momentum zeroed."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        m = sim.top.masses
        dof = sim.top.dof_mask
        sig = torch.sqrt(KB * float(self.config["md"]["temp_target"]) * ACCEL
                         / torch.clamp_min(m, 1e-6)) * dof
        v = torch.randn((self.replicas,) + tuple(sim.state.positions.shape),
                        generator=g, dtype=sim.dtype, device=self.device)
        v = v * sig[None, :, None]
        w = (m * dof)[None, :, None]
        p = (v * w).sum(1, keepdim=True) / w.sum()
        return (v - p) * dof[None, :, None]

    def window(self, seconds):
        """The measured window: back-to-back farm.step(dt, k) calls until
        `seconds` have passed; every step's work is in its time."""
        sync(self.device)
        t0 = time.perf_counter()
        steps = 0
        while True:
            self.farm.step(self.dt, self.k)
            steps += self.k
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        self.window_wall = time.perf_counter() - t0
        self.window_steps = steps
        self.peak_bytes = (torch.cuda.max_memory_allocated()
                           if self.device.type == "cuda" else 0)

    def ns_per_day(self):
        return (self.replicas * self.window_steps * self.dt * 1e-3
                / self.window_wall * 86400.0)

    # ------------------------------------------------------------------
    def reference(self):
        md = dict(self.config["md"])
        return System(self.arrays, self.statics, self.box, md, self.device)

    def traced(self):
        """The per-layer readings: a CUDA-only profile of a steady window of
        farm steps, made as the measured window makes them (calls of
        farm.step(dt, k), each ending in the farm's overflow read), the
        metric readers, the device's busy and window seconds, and the
        breakdown."""
        calls = -(-int(self.traffic["profile_steps"]) // self.k)

        def steady():
            for _ in range(calls):
                self.farm.step(self.dt, self.k)

        self.events, self.profile_wall = trace.profile_device(steady)
        self.profile_steps = calls * self.k
        ref = self.reference()
        xs = self.farm.x
        self.pairs = float(np.mean([ref.count_pairs(xs[r].double())
                                    for r in range(self.replicas)]))
        self.charged = int(((ref.q != 0) & ref.real).sum())
        self.sites = int(ref.real.sum())
        self.grid = tuple(int(g) for g in self.config["md"]["pme_grid"])
        del ref
        values = {}
        for m in cells.cell_metrics(self.bench, self.cell["name"],
                                    "per_layer"):
            v = cells.metric_reader(m["name"], self.root)(self)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        busy = trace.busy_seconds(self.events)
        breakdown = {"device_ops": trace.top_ops(self.events),
                     "idle_gaps": trace.idle_gaps(
                         lambda: self.farm.step(self.dt, self.k))}
        return values, busy, self.profile_wall, breakdown

    def check(self, free=True):
        """correct, the per-replica failures, the rows compared, the numbers
        and the per-replica readings: the captured step against the
        reference, after the program's state is freed (free=False keeps it
        for another start)."""
        cap = check.capture_steps(self.farm, self.dt)
        self.farm = None
        if free:
            self.sim = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        per = check.readings(cap, self.reference(), self.dt)
        self.check_seconds = time.perf_counter() - t
        nums = check.numbers(per)
        limits = cells.load_checks(self.cell["name"], self.root)
        ok, rows = check.judge(nums, limits)
        failed = sum(1 for p in per
                     if not check.judge(check.numbers([p]), limits)[0])
        return ok, failed, rows, nums, per
