"""Find a cell's parts by name and build what it runs.

Everything that belongs to one configuration, one traffic mix, one cell's
correctness limits or one per-layer metric sits in a file of its own, named
after it; this module is the only place that knows the layout:

  BENCHMARK.json                 the cells, metrics and bounds
  benchmark/configs/<c>.json     a configuration as it is run (+ <c>.py, the
                                 recipe make_data.py ran once for its data)
  benchmark/traffic/<t>.json     a traffic mix: replicas, dt, chunk, warm-up
  benchmark/checks/<cell>.json   the limits `correct` is decided by
  benchmark/metrics/<m>.py       a per-layer metric's reader, read(ctx)
"""
from __future__ import annotations

import importlib.util
import json
import os
import re

import numpy as np

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def _named(root, folder, name, ext):
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = os.path.join(root, "benchmark", folder, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"benchmark/{folder} has no {name!r}")
    return path


def load_bench(root):
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name, root):
    return _json(_named(root, "configs", name, ".json"))


def load_traffic(name, root):
    return _json(_named(root, "traffic", name, ".json"))


def load_checks(cell, root):
    return _json(_named(root, "checks", cell, ".json"))


def metric_reader(name, root):
    """The read(ctx) function of benchmark/metrics/<name>.py."""
    path = _named(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, key):
    """The `end_to_end` or `per_layer` entries that the cell reports."""
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def load_system(cfg, root, with_start=True):
    """(topology arrays, statics, box [3], start positions [N, 3]) from the
    configuration's data files (without_start: the builder's positions)."""
    with np.load(os.path.join(root, cfg["system"])) as d:
        arrays = {k: d[k] for k in d.files if not k.startswith("static_")
                  and k not in ("box", "positions")}
        statics = {k[len("static_"):]: d[k].item() for k in d.files
                   if k.startswith("static_")}
        box = np.asarray(d["box"], np.float32)
        x0 = np.asarray(d["positions"], np.float32)
    start = cfg["start"]
    if with_start and start.get("file"):
        with np.load(os.path.join(root, start["file"])) as d:
            x0 = np.asarray(d["x"], np.float32)
            if not np.allclose(np.asarray(d["box"], np.float64), box):
                raise ValueError(f"{start['file']}: box {d['box']} is not "
                                 f"the system's {box}")
    if x0.shape != arrays["masses"].shape + (3,):
        raise ValueError(f"start positions {x0.shape} for "
                         f"{arrays['masses'].shape[0]} sites")
    return arrays, statics, box, x0


def topology(arrays, statics, device):
    """The program's Topology of the raw arrays."""
    from molchanica_tpu_torch.topology import topology_from_numpy

    return topology_from_numpy(arrays, statics, device=device)


def md_config(md):
    """The program's MdConfig of a configuration's `md` block: the
    integrator and constraint as [constructor, kwargs], the rest as
    fields."""
    from molchanica_tpu_torch.md.config import (HydrogenConstraint,
                                                Integrator, MdConfig)

    kw = dict(md)
    name, args = kw.pop("integrator")
    integ = getattr(Integrator, name)(**args)
    name, args = kw.pop("hydrogen_constraint")
    hc = getattr(HydrogenConstraint, name)(**args)
    if kw.get("pme_grid") is not None:
        kw["pme_grid"] = tuple(int(k) for k in kw["pme_grid"])
    return MdConfig(integrator=integ, hydrogen_constraint=hc, **kw)
