"""The check decides `correct` on a whole run of the tiny cells with the
CPU in the card's place: a sound run is correct, and a run with the
timed path broken underneath is not (a step that returns its state
unchanged; half of the particles left out of the force, the rest at
twice the mass; one cell's force altered where it is produced; the
drift 1% long), nor is the TF32 control in the program's place. Each
fault is planted in the path the cell runs: the fast stepper
(ops/fast_treepm.py, tiny.late) or the engine's stateless KDK loop with
the PM (physics/integrators.py kdk_step_fused, forces/pm.py, tiny_pm.late).
One card has no exchange between chips to leave out."""

import pytest
import torch

from nbody_bench import harness

CELLS = ["tiny.late", "tiny_pm.late"]


def _run(tiny_dir, name="tiny.late"):
    return harness.run_cell(name, 7, 0.0, False, device="cpu",
                            root=tiny_dir, bench_dir=tiny_dir)


def _plant(monkeypatch, tiny_dir, name, fault):
    """Break the path cell `name` runs, as its configuration's law says
    (the stateless loop where it is "pm", else the fast stepper):
    "unchanged", "half", "altered" (a 5% larger x force in one region)
    or "drift"."""
    from lambda_cdm_tpu_torch.forces import pm
    from lambda_cdm_tpu_torch.ops import fast_treepm
    from lambda_cdm_tpu_torch.physics import integrators
    law = harness.Cell(name, root=tiny_dir, bench_dir=tiny_dir).geometry["law"]
    fast = law != "pm"
    if fault == "unchanged":
        if fast:
            monkeypatch.setattr(fast_treepm, "_fast_segment",
                                lambda fstate, params, dt, **kw: fstate)
        else:
            monkeypatch.setattr(integrators, "kdk_step_fused",
                                lambda state, acc, *a, **kw: (state, acc))
    elif fault == "drift":
        module = fast_treepm if fast else integrators
        drift = module.drift_factor
        monkeypatch.setattr(module, "drift_factor",
                            lambda a, mode="reference": 1.01 * drift(a, mode))
    elif fast:
        accel = fast_treepm._accel

        def broken(fstate, **kw):
            if fault == "half":
                m = fstate.bmass
                keep = (torch.arange(m.numel()) % 2 == 0).reshape(m.shape)
                return accel(fstate.replace(
                    bmass=torch.where(keep, 2.0 * m, 0.0)), **kw)
            acc, dropped = accel(fstate, **kw)
            acc = acc.clone()
            c = int(torch.argmax(torch.sum(fstate.bmass > 0, dim=1)))
            acc[:, c, 0] *= 1.05
            return acc, dropped

        monkeypatch.setattr(fast_treepm, "_accel", broken)
    else:
        accel = pm.pm_accelerations

        def broken(positions, masses, ng, box_size, *a, **kw):
            if fault == "half":
                keep = torch.arange(masses.numel()) % 2 == 0
                return accel(positions, torch.where(keep, 2.0 * masses, 0.0),
                             ng, box_size, *a, **kw)
            acc = accel(positions, masses, ng, box_size, *a, **kw).clone()
            acc[positions[:, 0] < box_size / 3, 0] *= 1.05
            return acc

        monkeypatch.setattr(pm, "pm_accelerations", broken)


@pytest.mark.parametrize("name", ["tiny.early", "tiny.late",
                                  "tiny_pm.late"])
def test_a_sound_run_is_correct(tiny_dir, name):
    r = _run(tiny_dir, name)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for name in harness.COMPARED:
        assert r["checks"][name]["value"] < r["checks"][name]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged(tiny_dir, monkeypatch,
                                                 name):
    _plant(monkeypatch, tiny_dir, name, "unchanged")
    r = _run(tiny_dir, name)
    assert not r["correct"]
    assert r["failed"] == 1 and r["checks"]["force_gap"]["value"] >= 1.0


@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_particles_left_out(tiny_dir, monkeypatch, name):
    _plant(monkeypatch, tiny_dir, name, "half")
    r = _run(tiny_dir, name)
    assert not r["correct"] and r["checks"]["force_gap"]["value"] > 0.1


@pytest.mark.parametrize("name", CELLS)
def test_one_force_altered_where_it_is_produced(tiny_dir, monkeypatch,
                                                name):
    _plant(monkeypatch, tiny_dir, name, "altered")
    r = _run(tiny_dir, name)
    assert not r["correct"]
    for name in ("force_gap", "kick_gap"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_drift_one_percent_long(tiny_dir, monkeypatch, name):
    _plant(monkeypatch, tiny_dir, name, "drift")
    r = _run(tiny_dir, name)
    assert not r["correct"]
    assert r["checks"]["drift_gap"]["value"] \
        > r["checks"]["drift_gap"]["limit"]
    assert r["checks"]["force_gap"]["value"] \
        < r["checks"]["force_gap"]["limit"]


@pytest.mark.parametrize("name", ["tiny.early", "tiny.late",
                                  "tiny_pm.late"])
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
