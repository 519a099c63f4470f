"""On the card: the tiny cell passes, and the control fails: the same
program with TF32 switched on for its matrix products (PME's spread and
transforms), the precision step below the float32 the configurations
state. Skips without a card."""
import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import make_root


@pytest.mark.card
@pytest.mark.parametrize("backend", ["clusters", "pallas"])
def test_program_passes_and_tf32_control_fails(card, tmp_path, backend):
    root, bench = make_root(tmp_path, backend=backend,
                            cutoff=6.0 if backend == "pallas" else 9.0)
    run = harness.Run(root, "tiny.cell", 3000000021, card, bench)
    run.setup()
    run.window(0.5)
    ok, _, _, nums, _ = run.check(free=False)
    assert ok, nums
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        run.start(3000000022)
        run.window(0.5)
        ok_c, _, _, nums_c, _ = run.check()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{backend}: sound {nums}, TF32 control {nums_c}")
    assert not ok_c, nums_c
