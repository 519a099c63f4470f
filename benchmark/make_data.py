"""Write a configuration's data files: `python benchmark/make_data.py
<config> [--device cpu|cuda]`.

The configuration's JSON names them. `system` gets the topology that
`configs/<config>.py::build()` assembles (every tensor field and static of
the port's Topology) with its box and positions. Where the JSON's `start`
has `fire_iters`, the start state is that many FIRE iterations of MdSim at
the configuration's MdConfig from those positions, then the Langevin steps
its `equilibrate` lists ([dt_ps, steps] stages), written to `start.file`
(this wants the card for a system of thousands of sites). A benchmark run
reads only these files, never the builder.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _recipe(name):
    path = os.path.join(HERE, "configs", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_recipe_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_system(asys, path):
    """Write an assembled system's topology (every tensor field and static
    of the port's Topology), box and positions to `path`; its topology."""
    from molchanica_tpu_torch.topology import STATIC_FIELDS, TENSOR_FIELDS

    top = asys.topology
    out = {f: getattr(top, f).cpu().numpy() for f in TENSOR_FIELDS}
    out.update({f"static_{s}": np.asarray(getattr(top, s))
                for s in STATIC_FIELDS})
    out["box"] = np.asarray(asys.box_extent, np.float32)
    out["positions"] = np.asarray(asys.positions, np.float32)
    np.savez_compressed(path, **out)
    return top


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--skip-system", action="store_true",
                    help="keep the system file; only make the start state")
    ap.add_argument("--skip-start", action="store_true",
                    help="make the system file only")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import cells
    cfg = cells.load_config(a.config, ROOT)
    sys_path = os.path.join(ROOT, cfg["system"])
    if not a.skip_system:
        t0 = time.perf_counter()
        top = write_system(_recipe(a.config).build(), sys_path)
        print(f"{a.config}: {top.n_atoms_real} real sites ({top.n_atoms} "
              f"padded), {top.water_count} waters, built in "
              f"{time.perf_counter() - t0:.1f} s -> {cfg['system']}")
    start = cfg["start"]
    if start.get("fire_iters") and not a.skip_start:
        from molchanica_tpu_torch.md.engine import MdSim

        arrays, statics, box, x0 = cells.load_system(cfg, ROOT,
                                                   with_start=False)
        top = cells.topology(arrays, statics, "cpu")
        md_cfg = cells.md_config(cfg["md"]).replace(
            max_init_relaxation_iters=int(start["fire_iters"]))
        t0 = time.perf_counter()
        sim = MdSim(top, md_cfg, x0, box_extent=box,
                    method=cfg["method"], device=a.device)
        r = sim.relax_log
        print(f"{a.config}: FIRE {r['iters']} iterations on {a.device} in "
              f"{time.perf_counter() - t0:.1f} s ({r['path']}, kept "
              f"{r['kept']}, E {r['e_first']:.3f} -> {r['e_end']:.3f} "
              f"kcal/mol)", flush=True)
        temps = []
        for dt, n in start.get("equilibrate", []):
            t0 = time.perf_counter()
            for _ in range(int(n) // 100):
                sim.step(float(dt), 100)
                temps.append(round(sim.temperature(), 2))
            print(f"{a.config}: {n} steps of {dt} ps in "
                  f"{time.perf_counter() - t0:.1f} s; T every 100 steps "
                  f"{temps[-(int(n) // 100):]}", flush=True)
        x = sim.state.positions.detach().cpu().numpy().astype(np.float32)
        np.savez_compressed(os.path.join(ROOT, start["file"]), x=x, box=box,
                            fire_iters=np.asarray(r["iters"]),
                            fire_path=np.asarray(r["path"]),
                            fire_kept=np.asarray(r["kept"]),
                            fire_e_first=np.asarray(r["e_first"]),
                            fire_e_end=np.asarray(r["e_end"]),
                            equilibrate=np.asarray(start.get("equilibrate",
                                                             [])),
                            temperatures_K=np.asarray(temps))
        print(f"{a.config}: -> {start['file']}")


if __name__ == "__main__":
    main()
