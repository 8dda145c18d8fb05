"""The readers of the program's own spans and counters: a traced run of
the tiny cell on the CPU reports each of them, and each stays silent
where the program recorded nothing."""

import json
import shutil

import pytest

from conftest import ROOT
from nbody_bench import harness

BENCH = json.load(open(f"{ROOT}/BENCHMARK.json"))
PROGRAM_METRICS = [m for m in BENCH["per_layer"]
                   if m["source"] in ("program_span", "program_counter")]
NAMES = [m["name"] for m in PROGRAM_METRICS]


@pytest.fixture
def registry():
    from lambda_cdm_tpu_torch.utils import profiling
    profiling.reset_trace()
    yield profiling
    profiling.reset_trace()


def test_the_five_readers_are_listed():
    assert sorted(NAMES) == sorted([
        "rebucket_ms_per_step", "rebuckets_per_step",
        "kick_drift_ms_per_step", "sync_ms_per_chunk",
        "readbacks_per_step"])


def test_a_traced_tiny_run_reports_them(tiny_dir, tmp_path, registry):
    bench = tmp_path / "bench"
    shutil.copytree(tiny_dir, bench)
    b = json.loads((bench / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in b["workloads"]]
    b["per_layer"] += [dict(m, workloads=cells) for m in PROGRAM_METRICS]
    (bench / "BENCHMARK.json").write_text(json.dumps(b))
    r = harness.run_cell("tiny.early", 3, 0.0, True, device="cpu",
                         root=str(bench), bench_dir=str(bench))
    got = r["metrics"]
    assert set(NAMES) <= set(got)
    # tiny: chunks of 5 steps, the drift guard's cadence 1 (4 passes a
    # segment); a reset 2 readbacks, a chunk 8, a compact pass 4
    assert got["rebuckets_per_step"]["value"] == pytest.approx(4 / 5)
    assert got["readbacks_per_step"]["value"] == pytest.approx(
        (2 + 8 + 4 * 4) / 5)
    for name in ("rebucket_ms_per_step", "kick_drift_ms_per_step",
                 "sync_ms_per_chunk"):
        assert got[name]["value"] > 0.0
        assert got[name]["unit"] == "ms"


def test_each_reader_is_silent_on_an_empty_registry(registry):
    ctx = {"steps": 10, "n": 1000}
    assert harness.read_metrics(
        [{"name": n, "unit": "u"} for n in NAMES], ctx) == {}
    with registry.tracing(), registry.span("fast.kick"):
        registry.count("readbacks")       # no engine.chunk: no window
    assert harness.read_metrics(
        [{"name": n, "unit": "u"} for n in NAMES], ctx) == {}
