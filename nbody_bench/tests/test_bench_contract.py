"""BENCHMARK.json and the files it names, held to the benchmark contract
(the keys, names, units, bounds and time budget) and loaded as the
harness loads them."""

import glob
import json
import os
import re

import pytest

from conftest import ROOT
from nbody_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIG_FILES = sorted(glob.glob(os.path.join(ROOT, "nbody_bench", "configs",
                                             "*.json")))


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


def test_run_seconds_fits_the_full_check():
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("nbody_bench/") and c["file"] not in files
        files.add(c["file"])
        data = json.load(open(os.path.join(ROOT, c["file"])))
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in data
            assert not k.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    assert 1 <= len(BENCH["workloads"]) <= 24
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    for name in e2e | {m["name"] for m in BENCH["per_layer"]}:
        assert os.path.exists(os.path.join(ROOT, "nbody_bench", "metrics",
                                           name + ".py"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=os.path.basename)
def test_every_configuration_file_has_a_law_and_validates(path):
    """Every configuration file, also one whose cell BENCHMARK.json does
    not list yet, is the port's SimulationConfig with a law in the
    reference and segments of whole output chunks."""
    from lambda_cdm_tpu_torch.core.config import SimulationConfig
    from nbody_bench import reference
    data = json.load(open(path))
    assert reference.geometry(data)["law"] == data["forces"]["type"]
    SimulationConfig.from_dict(data).validate()
    steps = int(data["bench"]["segment_steps"])
    assert steps > 0
    assert steps % int(data["simulation"]["output_frequency"]) == 0
    assert _line(data["source"]) and len(data["reduced"]) <= 16


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_from_its_files(name):
    cell = harness.Cell(name)
    assert cell.steps % int(cell.config["simulation"]["output_frequency"]) \
        == 0
    assert set(cell.limits) == set(harness.COMPARED)
    assert all(0 < v < 1 for v in cell.limits.values())
    assert {m["name"] for m in cell.metrics(False)} >= {"setup_s"}
    assert len(cell.metrics(False)) >= 2 and cell.metrics(True)
    cfg = cell.engine_config(2.5e-6)
    cfg.validate()
    assert cfg.time.initial_timestep == 2.5e-6
    assert not cfg.integration.adaptive_timestep
    assert cfg.integration.max_dloga == 0.0
    # the run loop stops at a_final: a segment must start below it
    z_start = cell.traffic.get("evolve", {}).get(
        "z_end", cfg.cosmology.initial_redshift)
    assert 1.0 / (1.0 + z_start) < 1.0 / (1.0 + cfg.cosmology.final_redshift)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_covers_the_splits_support(name):
    """The reference's pair search is its own: cells no narrower than
    the split's support, whatever grid the port plans."""
    from nbody_bench import reference
    cell = harness.Cell(name)
    g = cell.geometry
    ncell = reference.search_grid(g["box"], g["rs"])
    assert ncell >= 3
    assert g["box"] / ncell >= 2 * reference.X_MAX * g["rs"]
    assert g["box"] / (ncell + 1) < 2 * reference.X_MAX * g["rs"]
