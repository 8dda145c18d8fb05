"""No JAX in the benchmark: a whole run on the tiny cell loads no module
whose top-level name is jax, jaxlib, flax or lambda_cdm_tpu (the port,
lambda_cdm_tpu_torch, is a name of its own), and the reference's own
imports hold nothing of the port."""

import json
import subprocess
import sys

from conftest import ROOT, TINY
from nbody_bench import harness


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = _top_level(
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from nbody_bench import harness\n"
        f"harness.run_cell('tiny.early', 1, 0.0, False, device='cpu', "
        f"root={TINY!r}, bench_dir={TINY!r})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "lambda_cdm_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    loaded = _top_level(
        "import json, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import nbody_bench.reference, nbody_bench.inputs, "
        "nbody_bench.cosmo, nbody_bench.trace\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & (set(harness.FORBIDDEN) | {"lambda_cdm_tpu_torch"})


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lambda_cdm_tpu_torch_x", sys)
    assert "lambda_cdm_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "lambda_cdm_tpu.core", sys)
    assert {"jax.numpy", "lambda_cdm_tpu.core"} <= set(
        harness.forbidden_modules())
