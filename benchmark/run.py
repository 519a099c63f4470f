"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout, on a machine with the card(s) the cell
asks for. It builds the cell's configuration, fans it out into a replica
farm, warms up, measures for --seconds, and with --trace 1 reads the
per-layer metrics; then it checks one more farm step against the plain
float64 reference and prints one JSON line, last on standard output.
Without a card it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _process_start() -> float:
    """The epoch time at which this process started."""
    with open("/proc/self/stat") as fh:
        ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fail(msg, code=1):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark import cells, harness

    bench = cells.load_bench(ROOT)
    cell = cells.workload(bench, a.workload)
    try:
        import molchanica_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    here = os.path.dirname(os.path.dirname(
        os.path.abspath(molchanica_tpu_torch.__file__)))
    if here != ROOT:
        fail(f"molchanica_tpu_torch loads from {here}, not the checkout "
             f"{ROOT}")

    import torch

    torch.set_num_threads(2)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        fail(f"{a.workload} needs {cell['chips']} CUDA card(s); "
             f"available: {torch.cuda.is_available()}, count "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
             2)
    run = harness.Run(ROOT, a.workload, a.seed, "cuda", bench)
    run.setup()
    setup_s = time.time() - T_START
    run.window(a.seconds)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(run.peak_bytes),
              "power_limit": power_limit()}
    out = {}
    traced_s = 0.0
    if a.trace:
        t = time.perf_counter()
        metrics, busy, wall, breakdown = run.traced()
        traced_s = time.perf_counter() - t
        device["busy_s"] = busy
        device["window_s"] = wall
        out["breakdown"] = breakdown
    else:
        metrics = {}
        values = {"ns_per_day": run.ns_per_day(),
                  "peak_mem_gib": run.peak_bytes / 2 ** 30,
                  "setup_s": setup_s}
        for m in cells.cell_metrics(bench, a.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    ok, failed, rows, nums, _ = run.check()
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}")
    window = {"farm_steps": run.window_steps, "wall_s": run.window_wall,
              "replicas": run.replicas, "dt_ps": run.dt,
              "steps_per_call": run.k}
    print(f"[bench] {a.workload} seed {a.seed}: set-up {setup_s:.3f} s "
          f"({', '.join(f'{k} {v:.3f}' for k, v in run.split.items())}), "
          f"window {json.dumps(window)}, traced {traced_s:.3f} s, "
          f"check {run.check_seconds:.3f} s; "
          f"diagnostics {json.dumps(nums)}", file=sys.stderr)
    for name, v, lim, kind in rows:
        print(f"[check] {name} {v!r} {'<=' if kind == 'max' else '>='} "
              f"{lim!r}", file=sys.stderr)
    print(f"[check] correct {ok}", file=sys.stderr, flush=True)
    out.update(correct=ok, attempted=run.replicas, failed=failed,
               metrics=metrics, device=device,
               setup_split=run.split, window=window,
               checks=[[n, v, lim] for n, v, lim, _ in rows])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
