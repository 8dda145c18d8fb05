"""The check decides `correct` on a whole run of the tiny cell with the
CPU in the card's place: a sound run is correct, and a run with the
timed path broken underneath is not (a step that returns its state
unchanged; half of the particles left out of the force, the rest at
twice the mass; one cell's force altered where it is produced; the
drift 1% long), nor is the TF32 control in the program's place. One
card has no exchange between chips to leave out."""

import pytest
import torch

from nbody_bench import harness


def _run(tiny_dir, name="tiny.late"):
    return harness.run_cell(name, 7, 0.0, False, device="cpu",
                            root=tiny_dir, bench_dir=tiny_dir)


@pytest.mark.parametrize("name", ["tiny.early", "tiny.late"])
def test_a_sound_run_is_correct(tiny_dir, name):
    r = _run(tiny_dir, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for name in harness.COMPARED:
        assert r["checks"][name]["value"] < r["checks"][name]["limit"]


def test_a_step_that_returns_its_state_unchanged(tiny_dir, monkeypatch):
    from lambda_cdm_tpu_torch.ops import fast_treepm
    monkeypatch.setattr(fast_treepm, "_fast_segment",
                        lambda fstate, params, dt, **kw: fstate)
    r = _run(tiny_dir)
    assert not r["correct"]
    assert r["failed"] == 1 and r["checks"]["force_gap"]["value"] >= 1.0


def test_half_of_the_particles_left_out(tiny_dir, monkeypatch):
    from lambda_cdm_tpu_torch.ops import fast_treepm
    accel = fast_treepm._accel

    def half(fstate, **kw):
        m = fstate.bmass
        keep = (torch.arange(m.numel()) % 2 == 0).reshape(m.shape)
        return accel(fstate.replace(bmass=torch.where(keep, 2.0 * m, 0.0)),
                     **kw)

    monkeypatch.setattr(fast_treepm, "_accel", half)
    r = _run(tiny_dir)
    assert not r["correct"] and r["checks"]["force_gap"]["value"] > 0.1


def test_one_force_altered_where_it_is_produced(tiny_dir, monkeypatch):
    from lambda_cdm_tpu_torch.ops import fast_treepm
    accel = fast_treepm._accel

    def altered(fstate, **kw):
        acc, dropped = accel(fstate, **kw)
        acc = acc.clone()
        c = int(torch.argmax(torch.sum(fstate.bmass > 0, dim=1)))
        acc[:, c, 0] *= 1.05
        return acc, dropped

    monkeypatch.setattr(fast_treepm, "_accel", altered)
    r = _run(tiny_dir)
    assert not r["correct"]
    for name in ("force_gap", "kick_gap"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"]


def test_a_drift_one_percent_long(tiny_dir, monkeypatch):
    from lambda_cdm_tpu_torch.ops import fast_treepm
    drift = fast_treepm.drift_factor
    monkeypatch.setattr(fast_treepm, "drift_factor",
                        lambda a, mode="reference": 1.01 * drift(a, mode))
    r = _run(tiny_dir)
    assert not r["correct"]
    assert r["checks"]["drift_gap"]["value"] \
        > r["checks"]["drift_gap"]["limit"]
    assert r["checks"]["force_gap"]["value"] \
        < r["checks"]["force_gap"]["limit"]


@pytest.mark.parametrize("name", ["tiny.early", "tiny.late"])
def test_the_tf32_control_is_not_correct(tiny_dir, name):
    cell = harness.Cell(name, root=tiny_dir, bench_dir=tiny_dir)
    run = harness.Run(cell, 11, "cpu")
    run.window(0.0)
    steps = run.check_steps()
    targets = run.targets(steps["xs"].positions)
    want = harness.reference_step(cell, steps, targets, run.dt)
    checks, correct = harness.judge(
        harness.program_step(cell, steps, targets), want, run, cell.limits)
    assert correct, checks
    control = harness.reference_step(cell, steps, targets, run.dt,
                                     precision="tf32")
    checks, correct = harness.judge(control, want, run, cell.limits)
    assert not correct
    assert checks["force_gap"]["value"] > checks["force_gap"]["limit"]
