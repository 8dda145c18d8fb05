"""The PyTorch port's package boundary: it imports without JAX, loads every
example config to the same dict as the JAX package, and its kernel
wrappers never fall back to the plain version for a non-CPU tensor."""

import glob
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one intra-op thread per worker)

import lambda_cdm_tpu.core.config as jconfig
from lambda_cdm_tpu_torch.core import config as tconfig
from lambda_cdm_tpu_torch.ops import cuda_build, lens_sample, pm_rods, \
    short_range

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "lambda_cdm_tpu_torch")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "examples", "configs",
                                        "*.json")))


def test_imports_with_jax_blocked():
    """Every submodule imports in a process where `import jax` fails."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import lambda_cdm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'lambda_cdm_tpu' not in sys.modules\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_sources():
    offenders = []
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(path) as f:
            for line in f:
                s = line.strip()
                if s.startswith(("import jax", "from jax",
                                 "import lambda_cdm_tpu.",
                                 "from lambda_cdm_tpu.",
                                 "from lambda_cdm_tpu import")):
                    offenders.append(f"{path}: {s}")
    assert not offenders, offenders


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_example_configs_load_identically(path):
    jc = jconfig.SimulationConfig.from_file(path)
    tc = tconfig.SimulationConfig.from_file(path)
    assert tc.to_dict() == jc.to_dict()
    # validate() agrees too, including where the JAX package refuses a
    # config on one device (multichip_512 needs compute.mesh enabled)
    try:
        jc.validate()
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            tc.validate()
        assert str(got.value) == str(exc)
    else:
        tc.validate()
    assert tc.to_dict() == jc.to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_auto_pm_grid_matches(path):
    from lambda_cdm_tpu.forces import auto_pm_grid as jgrid
    from lambda_cdm_tpu_torch.forces import auto_pm_grid as tgrid
    jc = jconfig.SimulationConfig.from_file(path)
    tc = tconfig.SimulationConfig.from_file(path)
    assert tgrid(tc) == jgrid(jc)
    for n in (1000, 32 ** 3, 10 ** 6):
        jc.forces.pm_grid_size = tc.forces.pm_grid_size = 0
        jc.particles.num_particles = tc.particles.num_particles = n
        assert tgrid(tc) == jgrid(jc)


def test_cosmology_params_from_config_match():
    path = os.path.join(ROOT, "examples", "configs", "treepm_1m.json")
    jp = jconfig.SimulationConfig.from_file(path).cosmology_params()
    tp = tconfig.SimulationConfig.from_file(path).cosmology_params()
    for name in ("omega_m", "omega_lambda", "omega_b", "h", "sigma8",
                 "n_s", "w0", "wa", "t_cmb"):
        assert float(getattr(tp, name)) == float(getattr(jp, name)), name


def _bucket_args(device):
    ncell, cap = 3, 8
    bpos = torch.zeros((3, ncell ** 3, cap), device=device)
    bmass = torch.zeros((ncell ** 3, cap), device=device)
    counts = torch.zeros((ncell ** 3,), dtype=torch.int32, device=device)
    return bpos, bmass, counts, ncell, cap


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card must raise:
    the plain version is taken only because the tensor lies on the CPU."""
    bpos, bmass, counts, ncell, cap = _bucket_args("meta")
    geo = dict(ncell=ncell, ng=6, box_size=3.0)
    before = dict(pm_rods.launches, **short_range.launches,
                  **lens_sample.launches)
    with pytest.raises(ValueError, match="cuda"):
        pm_rods.cic_deposit(bpos, bmass, counts, **geo)
    phi = torch.zeros((6, 6, 6), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        pm_rods.fd4_gather(phi, bpos, counts, **geo)
    with pytest.raises(ValueError, match="cuda"):
        short_range.short_range(bpos, bmass, counts, ncell=ncell,
                                capacity=cap, box_size=3.0, rs=0.1,
                                softening=0.01)
    fields, xy = torch.zeros((3, 16, 16), device="meta"), torch.zeros(
        (5, 2), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        lens_sample.bilinear_sample_fields(fields, xy, 3.0)
    with pytest.raises(ValueError, match="cuda"):
        lens_sample.bilinear_sample_fields_xwin(fields, xy, 3.0, window=2)
    assert dict(pm_rods.launches, **short_range.launches,
                **lens_sample.launches) == before


def test_cpu_tensors_take_plain_version_without_counting():
    bpos, bmass, counts, ncell, cap = _bucket_args("cpu")
    before = dict(pm_rods.launches, **short_range.launches)
    grid, dropped = pm_rods.cic_deposit(bpos, bmass, counts, ncell=ncell,
                                        ng=6, box_size=3.0)
    assert grid.shape == (6, 6, 6) and int(dropped) == 0
    acc = short_range.short_range(bpos, bmass, counts, ncell=ncell,
                                  capacity=cap, box_size=3.0, rs=0.1,
                                  softening=0.01)
    assert acc.shape == (3, ncell ** 3, cap)
    assert dict(pm_rods.launches, **short_range.launches) == before


def test_short_range_rejects_bad_geometry():
    bpos, bmass, counts, _, cap = _bucket_args("cpu")
    kw = dict(capacity=cap, box_size=3.0, rs=0.1)
    with pytest.raises(ValueError, match="softening"):
        short_range.short_range(bpos, bmass, counts, ncell=3,
                                softening=0.0, **kw)
    small = torch.zeros((3, 8, cap))
    with pytest.raises(ValueError, match="ncell"):
        short_range.short_range(small, torch.zeros((8, cap)),
                                torch.zeros(8, dtype=torch.int32), ncell=2,
                                softening=0.01, **kw)


def test_kernel_build_needs_the_cuda_toolkit(monkeypatch):
    """The library name is keyed by the sources; without nvcc the build
    says so instead of running anything else."""
    path = cuda_build.library_path()
    assert path.startswith(cuda_build.BUILD_DIR)
    assert path == cuda_build.library_path()
    srcs = [os.path.basename(s) for s in cuda_build._sources()]
    assert srcs == ["alias_probe.cu", "cic_deposit.cu", "direct.cu",
                    "fd4_gather.cu",
                    "fof_hook.cu", "lens_sample.cu", "short_range.cu",
                    "short_range_rd.cu"]
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build, "NVCC_DEFAULT",
                        os.path.join(ROOT, "no-such-dir", "nvcc"))
    monkeypatch.setattr(cuda_build, "BUILD_DIR",
                        os.path.join(ROOT, "no-such-dir", "_build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build()
    assert not os.path.exists(os.path.join(ROOT, "no-such-dir"))


def test_interop_round_trip():
    from lambda_cdm_tpu_torch import interop
    rng = np.random.default_rng(0)
    d = {"positions": rng.uniform(0, 1, (5, 3)).astype(np.float32),
         "velocities": rng.normal(size=(5, 3)).astype(np.float32),
         "masses": np.ones(5, np.float32), "scale_factor": np.float32(0.1),
         "time": np.float32(0.5), "step": np.int32(3),
         "rng_key": np.zeros(2, np.uint32)}
    # the loaders default to the card, as every entry point of the port
    for fn in (interop.sim_state_from_arrays, interop.fast_state_from_arrays):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    st = interop.sim_state_from_arrays(d, device="cpu")
    back = interop.sim_state_to_arrays(st)
    for k in ("positions", "velocities", "masses", "scale_factor", "time",
              "step"):
        np.testing.assert_array_equal(back[k], d[k])
    assert st.scale_factor.dtype == torch.float32
    assert st.step.dtype == torch.int32
