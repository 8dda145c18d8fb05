"""The port's spans and counters (utils/profiling: span, count,
trace_totals) on a 2048-particle treepm_fast engine on the CPU: off
without a profiler (no record_function, nothing kept), on under
torch.profiler with the counters in closed form and every span in the
exported trace, traced and untraced runs bit-identical, and
profiling.detailed_timing's measured force time. The `cuda` cases hold
the readbacks counter to the card's sync-debug mode and K3's device
counters to the window that ran K3 (skip without a card; on the card
host: python -m pytest tests/test_torch_tracing.py -m cuda --noconftest
-q).
"""

import json
import traceback
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lambda_cdm_tpu_torch as tlc
from lambda_cdm_tpu_torch.ops import fast_treepm
from lambda_cdm_tpu_torch.ops.fast_treepm import next_rebucket_offset
from lambda_cdm_tpu_torch.utils import profiling

N, BOX, CHUNK, EVERY = 2048, 40.0, 8, 4
# every span the fast path opens inside a chunk (engine.init_fast and
# fast.build open in the reset, engine.grow only on an overflow)
CHUNK_SPANS = ("engine.cadence", "engine.sync_state", "fast.rebucket",
               "fast.kick", "fast.drift", "fast.accel", "fast.pm",
               "fast.short_range")
RESET_SPANS = ("engine.init_fast", "fast.build")


def _config(forces="treepm_fast", detailed_timing=False):
    return tlc.SimulationConfig.from_dict({
        "particles": {"num_particles": N, "box_size": BOX},
        "forces": {"type": forces, "pm_grid_size": 24,
                   "softening_length": 1.0, "rebucket_every": EVERY},
        "cosmology": {"model": "Newtonian", "final_redshift": -0.5},
        "time": {"initial_timestep": 1.0, "final_time": 1e9},
        "units": {"system": "box", "G": 1e-8},
        "simulation": {"output_frequency": CHUNK,
                       "checkpoint_frequency": 0},
        "profiling": {"output_file": "", "detailed_timing": detailed_timing},
        "logging": {"performance_logging": False}})


def _engine(device="cpu", **kw):
    rng = np.random.default_rng(19)
    pos = rng.uniform(0.0, BOX, (N, 3)).astype(np.float32)
    vel = rng.normal(0.0, 0.01, (N, 3)).astype(np.float32)
    st = tlc.make_state(pos, vel, np.full(N, 1e-3, np.float32),
                        scale_factor=1.0)
    return (tlc.SimulationBuilder(device=device).with_config(_config(**kw))
            .with_initial_state(st).build())


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset_trace()
    yield
    profiling.reset_trace()


def _segment(eng, steps):
    """A benchmark segment: a reset through the public setter, then
    `steps` steps."""
    eng.state = eng.state
    return eng.run(num_steps=steps)


def _expected_counts(eng, steps):
    """(rebuckets, readbacks) of a segment in closed form: fast_run's
    passes from the cadence carried by next_rebucket_offset; a reset 2
    readbacks (the box tensor's copy in bucket_src_map, the synchronize),
    a chunk 8 (vmax, dropped twice, four boolean masks, the
    synchronize), a pass 3 (the box tensor, the overflow twice) and the
    compact form's nonzero."""
    every = eng._fast_cadence(CHUNK)
    assert every == EVERY                 # the drift guard does not bind
    since, passes = 0, 0
    for _ in range(steps // CHUNK):
        passes += (since + CHUNK - 1) // every
        since = next_rebucket_offset(since, CHUNK, every)
    compact = eng._fstate.bmass.numel() > 4 * N
    return passes, 2 + 8 * (steps // CHUNK) + passes * (3 + compact)


def test_off_is_a_shared_no_op(monkeypatch):
    """No profiler, no tracing(): span and count record nothing and never
    reach record_function or a CUDA event."""
    def boom(*a, **k):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    assert not profiling.tracing_on()
    assert profiling.span("a", device=True) is profiling.span("b")
    eng = _engine()
    _segment(eng, 2 * CHUNK)
    assert profiling.trace_totals() == {"spans": {}, "counters": {}}


def test_counters_and_spans_under_the_profiler(tmp_path):
    eng = _engine()
    steps = 3 * CHUNK
    rebuckets, readbacks = _expected_counts(eng, steps)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _segment(eng, steps)
    tot = profiling.trace_totals()
    assert tot["counters"] == {"rebuckets": rebuckets,
                               "readbacks": readbacks}
    spans = tot["spans"]
    chunks = steps // CHUNK
    want = {"engine.chunk": chunks, "engine.cadence": chunks,
            "engine.sync_state": chunks, "fast.rebucket": rebuckets,
            "fast.kick": steps, "fast.drift": steps,
            "fast.accel": steps + 1, "fast.pm": steps + 1,
            "fast.short_range": steps + 1, "engine.init_fast": 1,
            "fast.build": 1}
    assert {k: v["count"] for k, v in spans.items()} == want
    assert spans["fast.accel"]["parents"] == ["engine.init_fast",
                                              "engine.chunk"]
    assert spans["fast.pm"]["parents"] == ["fast.accel"]
    assert spans["fast.build"]["parents"] == ["engine.init_fast"]
    assert spans["engine.chunk"]["parents"] == [None]
    assert spans["fast.kick"]["first_step"] == 0
    assert spans["fast.kick"]["last_step"] == steps - 1
    assert spans["fast.rebucket"]["first_step"] == EVERY
    for v in spans.values():              # the CPU: device = host
        assert v["device_s"] == v["host_s"] >= v["self_s"] >= 0.0
    accel = spans["fast.accel"]
    assert accel["self_s"] == pytest.approx(
        accel["host_s"] - spans["fast.pm"]["host_s"]
        - spans["fast.short_range"]["host_s"], abs=1e-9)

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    seen = {}
    for e in events:
        seen[e["name"]] = seen.get(e["name"], 0) + 1
    assert {k: seen.get(k, 0) for k in want} == want
    chunk_ev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e["name"] == "engine.chunk"]
    reset = [e for e in events if e["name"] == "engine.init_fast"]
    for e in events:
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        inside = any(c0 <= t0 and t1 <= c1 for c0, c1 in chunk_ev)
        in_reset = any(float(r["ts"]) <= t0 and t1 <= float(r["ts"])
                       + float(r["dur"]) for r in reset)
        if e["name"] in CHUNK_SPANS:
            assert inside or (e["name"] in ("fast.accel", "fast.pm",
                                            "fast.short_range")
                              and in_reset), e
        elif e["name"] in RESET_SPANS:
            assert not inside


def test_traced_and_untraced_runs_are_bit_identical():
    a, b = _engine(), _engine()
    _segment(a, 2 * CHUNK)
    with profile(activities=[ProfilerActivity.CPU]):
        _segment(b, 2 * CHUNK)
    assert profiling.trace_totals()["counters"]["rebuckets"] > 0
    for f in ("positions", "velocities", "masses"):
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    assert int(a.state.step) == int(b.state.step) == 2 * CHUNK


def test_tracing_context_without_a_profiler(monkeypatch):
    """profiling.tracing() alone records, and record_function is left to
    an active profiler."""
    def boom(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    eng = _engine()
    with profiling.tracing():
        assert profiling.tracing_on()
        _segment(eng, CHUNK)
    assert not profiling.tracing_on()
    tot = profiling.trace_totals()
    assert tot["spans"]["engine.chunk"]["count"] == 1
    assert tot["counters"]["readbacks"] == _expected_counts(eng, CHUNK)[1]


def test_span_nesting_self_time_and_reset():
    with profiling.tracing():
        profiling.set_step(7)
        with profiling.span("outer"):
            with profiling.span("inner"):
                profiling.count("hits", 2)
            with profiling.span("inner"):
                pass
        profiling.count("hits")
    tot = profiling.trace_totals()
    outer, inner = tot["spans"]["outer"], tot["spans"]["inner"]
    assert (outer["count"], inner["count"]) == (1, 2)
    assert inner["parents"] == ["outer"] and outer["parents"] == [None]
    assert outer["self_s"] == pytest.approx(outer["host_s"]
                                            - inner["host_s"], abs=1e-9)
    assert inner["first_step"] == inner["last_step"] == 7
    assert tot["counters"] == {"hits": 3}
    profiling.reset_trace()
    assert profiling.trace_totals() == {"spans": {}, "counters": {}}


def test_profiler_timer_is_a_span_and_the_report_holds_them(tmp_path):
    prof = profiling.Profiler()
    with profiling.tracing():
        with prof.timer("analysis.x"):
            profiling.count("readbacks")
        with prof.timer("run.chunk", span_name="engine.chunk"):
            pass
    path = tmp_path / "report.json"
    prof.write_report(str(path))
    report = json.loads(path.read_text())
    assert set(report["timers"]) == {"analysis.x", "run.chunk"}
    assert set(report["spans"]) == {"analysis.x", "engine.chunk"}
    assert report["counters"] == {"readbacks": 1}


def test_grow_is_traced():
    """A collapsing start overflows the planned capacity: the regrowth is
    the span engine.grow inside its chunk, with its rebuilds fast.build."""
    n, box = 600, 30.0
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, box, (n, 3)).astype(np.float32)
    vel = ((box / 2.0 - pos) * 0.118).astype(np.float32)
    cfg = _config()
    cfg.particles.num_particles, cfg.particles.box_size = n, box
    cfg.forces.rebucket_every = 8
    cfg.simulation.output_frequency = 16
    eng = (tlc.SimulationBuilder(device="cpu").with_config(cfg)
           .with_initial_state(tlc.make_state(
               pos, vel, np.full(n, 1e-6, np.float32), scale_factor=1.0))
           .build())
    cap0 = eng._fast_kw["capacity"]
    with profiling.tracing():
        eng.run(num_steps=16)
    assert eng._fast_kw["capacity"] > cap0
    spans = profiling.trace_totals()["spans"]
    assert spans["engine.grow"]["parents"] == ["engine.chunk"]
    assert spans["fast.build"]["parents"] == ["engine.grow"]
    assert spans["fast.build"]["count"] >= spans["engine.grow"]["count"] >= 1


def test_detailed_timing_measures_the_force(monkeypatch):
    """detailed_timing: force_time_s is the fast.accel spans' time, with
    _accel called once a step and once at initialisation (no extra
    evaluations); off, both times stay 0.0."""
    calls = []
    accel = fast_treepm._accel

    def counting(*a, **k):
        calls.append(1)
        return accel(*a, **k)

    monkeypatch.setattr(fast_treepm, "_accel", counting)
    eng = _engine(detailed_timing=True)
    assert len(calls) == 1
    eng.run(num_steps=2 * CHUNK)
    st = eng.statistics
    assert len(calls) == 1 + 2 * CHUNK
    assert 0.0 < st.force_time_s <= st.compute_time_s
    assert st.integration_time_s == pytest.approx(
        st.compute_time_s - st.force_time_s)
    assert not profiling.tracing_on()
    off = _engine(detailed_timing=False)
    off.run(num_steps=CHUNK)
    assert off.statistics.force_time_s == 0.0
    assert off.statistics.integration_time_s == 0.0


def test_detailed_timing_on_a_stateless_solver():
    eng = _engine(forces="pm", detailed_timing=True)
    eng.run(num_steps=CHUNK)
    st = eng.statistics
    assert 0.0 < st.force_time_s <= st.compute_time_s
    assert profiling.trace_totals()["spans"]["fast.accel"]["count"] == \
        CHUNK + 1


@pytest.mark.cuda
def test_readbacks_match_the_cards_sync_debug_mode():
    """One segment on the card under sync-debug mode "warn": the
    synchronizing operations it warns of from the program's frames (the
    mode's first switch in a process warns once inside torch) plus the
    explicit synchronizes equal the program's readbacks counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU host: python -m pytest "
                    "tests/test_torch_tracing.py -m cuda --noconftest)")
    eng = _engine(device="cuda")
    _segment(eng, CHUNK)                  # builds the kernels, warms up
    torch.cuda.synchronize()
    n = {"warned": 0, "synchronized": 0}
    real = torch.cuda.synchronize

    def counting(*a, **k):
        n["synchronized"] += 1
        return real(*a, **k)

    def on_warning(message, *a, **k):
        if "synchroniz" in str(message) and any(
                "lambda_cdm_tpu_torch" in f.filename
                for f in traceback.extract_stack()):
            n["warned"] += 1

    profiling.reset_trace()
    try:
        torch.cuda.synchronize = counting
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            with profiling.tracing():
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    _segment(eng, 2 * CHUNK)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    finally:
        torch.cuda.synchronize = real
    tot = profiling.trace_totals()
    assert n["warned"] > 0
    assert tot["counters"]["readbacks"] == n["warned"] + n["synchronized"]
    assert tot["spans"]["fast.accel"]["device_s"] > 0.0


@pytest.mark.cuda
def test_device_counters_end_with_their_window():
    """K3's device counters report in the window that ran K3 on the card
    and in no later one: after reset_trace(), a CPU segment under the
    profiler counts exactly the CPU counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU host: python -m pytest "
                    "tests/test_torch_tracing.py -m cuda --noconftest)")
    with profiling.tracing():
        _segment(_engine(device="cuda"), CHUNK)
    counters = profiling.trace_totals()["counters"]
    assert counters["k3_j_tested"] >= counters["k3_j_kept"] > 0
    profiling.reset_trace()
    eng = _engine()
    rebuckets, readbacks = _expected_counts(eng, CHUNK)
    with profile(activities=[ProfilerActivity.CPU]):
        _segment(eng, CHUNK)
    assert profiling.trace_totals()["counters"] == {
        "rebuckets": rebuckets, "readbacks": readbacks}


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_fused_rebucket_counts_the_card_route(device):
    """`rebucket.launches` counts each rebucket pass that took the card's
    route (ops/rebucket.py): all of them on the card, none on the CPU,
    where the plain forms run. In fast_run a pass on the card makes one
    readback (its overflow), the plain forms 3 (the box tensor's copy, the
    overflow twice) and the compact form's nonzero."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU host: python -m pytest "
                    "tests/test_torch_tracing.py -m cuda --noconftest)")
    from lambda_cdm_tpu_torch.ops import rebucket
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    rng = np.random.default_rng(23)
    pos = torch.tensor(rng.uniform(0.0, BOX, (N, 3)), dtype=torch.float32,
                       device=device)
    vel = torch.tensor(rng.normal(0.0, 0.01, (N, 3)), dtype=torch.float32,
                       device=device)
    fs, kw = fast_treepm.initialize_fast(
        pos, vel, torch.full((N,), 1e-3, device=device), 1.0, box_size=BOX,
        pm_grid=24, softening=1.0, g_const=1e-8, kick_mode="newtonian",
        cosmological=False)
    compact = fs.bmass.numel() > 4 * N
    run = dict(rebucket_every=2, n_steps=2 * CHUNK, on_overflow="raise",
               **kw)
    fast_treepm.fast_run(fs, CosmologyParams(), 1.0, **run)   # warms up
    before = rebucket.launches["rebucket"]
    with profiling.tracing():
        fast_treepm.fast_run(fs, CosmologyParams(), 1.0, **run)
    counters = profiling.trace_totals()["counters"]
    card_passes = rebucket.launches["rebucket"] - before
    passes = CHUNK - 1
    assert counters["rebuckets"] == passes
    if device == "cpu":
        assert card_passes == 0
        assert counters["readbacks"] == passes * (3 + compact)
    else:
        assert card_passes == passes
        assert counters["readbacks"] == passes
