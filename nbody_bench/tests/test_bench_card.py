"""On the card: the tiny cells' runs (through K1, K2 and K3, and through
the stateless PM) are correct and the TF32 control is not (skips
without a card)."""

import pytest
import torch

from nbody_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny.early", "tiny.late",
                                  "tiny_pm.late"])
def test_tiny_cell_on_the_card(tiny_dir, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(name, 5, 0.0, False, device="cuda", root=tiny_dir,
                         bench_dir=tiny_dir)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
    cell = harness.Cell(name, root=tiny_dir, bench_dir=tiny_dir)
    run = harness.Run(cell, 6, "cuda")
    run.window(0.0)
    steps = run.check_steps()
    targets = run.targets(steps["xs"].positions)
    want = harness.reference_step(cell, steps, targets, run.dt)
    control = harness.reference_step(cell, steps, targets, run.dt,
                                     precision="tf32")
    assert not harness.judge(control, want, run, cell.limits)[1]
