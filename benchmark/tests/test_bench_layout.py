"""BENCHMARK.json against the contract's shape, and every part it names
found by name."""
import filecmp
import os
import re

import pytest

from benchmark import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_bench(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_text(bench):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert TEXT.match(e[key]), (e["name"], key)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_part_found_by_name(bench):
    for c in bench["configs"]:
        cfg = cells.load_config(c["name"], ROOT)
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for rel in (cfg["system"], cfg["start"].get("file")):
            if rel:
                assert os.path.exists(os.path.join(ROOT, rel)), rel
    for w in bench["workloads"]:
        assert w["config"] in {c["name"] for c in bench["configs"]}
        t = cells.load_traffic(w["traffic"], ROOT)
        assert t["replicas"] >= 1 and t["steps_per_call"] >= 1
        lim = cells.load_checks(w["name"], ROOT)
        assert lim["max"]
        for m in cells.cell_metrics(bench, w["name"], "per_layer"):
            assert callable(cells.metric_reader(m["name"], ROOT))
        e2e = {m["name"] for m in cells.cell_metrics(bench, w["name"],
                                                     "end_to_end")}
        assert {"setup_s", "ns_per_day", "peak_mem_gib"} <= e2e


def test_unknown_names_are_refused():
    with pytest.raises(FileNotFoundError):
        cells.load_traffic("no_such_mix", ROOT)
    with pytest.raises(ValueError):
        cells.load_config("../configs/config3_k2", ROOT)


def test_start_files_match_their_systems(bench):
    for c in bench["configs"]:
        cfg = cells.load_config(c["name"], ROOT)
        arrays, statics, box, x0 = cells.load_system(cfg, ROOT)
        assert x0.shape == (arrays["masses"].shape[0], 3)
        assert int(statics["n_atoms_real"]) == int(arrays["atom_mask"].sum())


def test_eq25k_is_the_fixture_byte_for_byte():
    a = os.path.join(ROOT, "benchmark", "data", "eq25k.npz")
    b = os.path.join(ROOT, "molchanica_tpu", "systems", "data", "eq25k.npz")
    assert filecmp.cmp(a, b, shallow=False)
