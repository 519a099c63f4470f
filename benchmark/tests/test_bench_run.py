"""run.py's refusals and the import guard."""
import ast
import glob
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGS = ["--workload", "config5_duplex.farm4", "--seed", "3000000019",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = _run(ROOT, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(tmp_path, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"molchanica_tpu_torch", "molchanica_tpu", "jax",
                           "jaxlib", "flax"}, path
    code = ("import sys, json; import benchmark.reference.physics; "
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       check=True)
    tops = set(json.loads(p.stdout))
    assert not tops & {"molchanica_tpu_torch", "molchanica_tpu", "jax",
                       "jaxlib", "flax"}


GUARD = """
import sys, json, tempfile
sys.path.insert(0, {root!r})
from benchmark.tests.tiny import make_root
from benchmark import harness
with tempfile.TemporaryDirectory() as tmp:
    root, bench = make_root(tmp)
    run = harness.Run(root, "tiny.cell", 5, "cpu", bench)
    run.setup()
    run.window(0.5)
    ok = run.check()[0]
print(json.dumps({{"correct": ok, "forbidden": harness.forbidden_modules(),
                  "program": "molchanica_tpu_torch" in sys.modules}}))
"""


def test_no_jax_after_a_run():
    p = subprocess.run([sys.executable, "-c", GUARD.format(root=ROOT)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600, check=True)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["program"] and out["forbidden"] == []
    assert out["correct"] is True


def test_forbidden_names_compare_whole_top_level_names():
    from benchmark import harness

    sys.modules["jaxlib_lookalike_for_test"] = sys
    try:
        assert "jaxlib_lookalike_for_test" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxlib_lookalike_for_test"]
