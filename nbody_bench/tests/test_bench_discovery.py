"""The harness finds a configuration, traffic mix, limit and metric by
name: a later change adds files and entries and edits none."""

import json
import shutil

from nbody_bench import harness, metrics


def test_new_traffic_and_cell_are_found_by_name(tiny_dir, tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(tiny_dir, bench)
    (bench / "traffic" / "later.json").write_text(json.dumps(
        {"why": "x", "realisation": 9, "check_targets": 8,
         "dense_targets": 2}))
    (bench / "limits" / "tiny.later.json").write_text(
        json.dumps({"force_gap": 0.5, "kick_gap": 0.5, "drift_gap": 0.5}))
    b = json.loads((bench / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "tiny.later", "config": "tiny",
                           "traffic": "later", "chips": 1, "why": "x"})
    (bench / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.Cell("tiny.later", root=str(bench), bench_dir=str(bench))
    assert cell.traffic["realisation"] == 9
    assert cell.limits["force_gap"] == 0.5
    assert cell.steps == 5           # the configuration's segment
    # the per-layer metrics list the cells they are read in
    assert cell.metrics(True) == []
    assert [m["name"] for m in cell.metrics(False)] == \
        [m["name"] for m in b["end_to_end"]]


def test_new_metric_file_is_read_by_name(tmp_path, monkeypatch):
    (tmp_path / "later_metric.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['n']\n")
    (tmp_path / "silent_metric.py").write_text(
        "def read(ctx):\n    return None\n")
    monkeypatch.setattr(metrics, "__path__",
                        list(metrics.__path__) + [str(tmp_path)])
    got = harness.read_metrics(
        [{"name": "later_metric", "unit": "x"},
         {"name": "silent_metric", "unit": "x"},
         {"name": "setup_s", "unit": "s"}],
        {"n": 21, "setup_s": 3.5})
    assert got == {"later_metric": {"value": 42.0, "unit": "x"},
                   "setup_s": {"value": 3.5, "unit": "s"}}
