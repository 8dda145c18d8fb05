"""The port's mesh engine (compute.mesh.enabled on 8 spawned gloo ranks,
tests/_torch_mesh_worker.py) against the JAX engine's mesh run on the
conftest's 8 virtual CPU devices (its _init_mesh_path takes every
device), from one numpy state, 6 steps in chunks of 2, so the particles
are homed before the first force and migrate after each chunk (the
emigrant-only exchange). On the 1D slab mesh: direct (the ring), pm (the
sharded PM), pm_fast (the sharded PM on uniform slabs), treepm (the halo
short range at PM 64, and the ring short range at PM 16, where the plan
is None) and treepm_fast with shz alone (the stateless sharded TreePM);
on {shx: 2, shy: 2, shz: 2}: direct and treepm (the block halo); on
{shx: 2, shy: 4} (the (2, 4, 1) grid): pm. direct and pm home against
load-adaptive bounds; the TreePM and pm_fast against uniform slabs and
blocks.

The gathered state is compared row for row: the same rows hold the same
particles (masses exactly, so every migration moved the same rows the
same way), positions to 1e-5 of the box and velocities to 1e-4 of the
largest (the stateless runs' bars), the energies to 1e-5.
"""

import numpy as np
import pytest

from _torch_mesh_worker import start_ranks

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state

N_RANKS = 8
N, BOX, STEPS = 1024, 50.0, 6


# name: (forces.type, compute.mesh.axes or None, pm grid)
CONFIGS = {"direct": ("direct", None, 16), "pm": ("pm", None, 16),
           "pm_fast": ("pm_fast", None, 16),
           "treepm": ("treepm", None, 64),
           "treepm_ring": ("treepm", None, 16),
           "treepm_fast_shz": ("treepm_fast", {"shz": 8}, 64),
           "direct_3d": ("direct", {"shx": 2, "shy": 2, "shz": 2}, 16),
           "treepm_3d": ("treepm", {"shx": 2, "shy": 2, "shz": 2}, 32),
           "pm_2d": ("pm", {"shx": 2, "shy": 4}, 16)}
AX2, AX3 = {"shx": 2, "shy": 4}, {"shx": 2, "shy": 2, "shz": 2}
# the port alone (no JAX run): every other solver on both grids, PM 32
GRID_ONLY = {f"{s}_{g}": (s, axes, 32)
             for s in ("direct", "direct_reference", "pm", "pm_fast",
                       "treepm")
             for g, axes in (("2d", AX2), ("3d", AX3))
             if f"{s}_{g}" not in CONFIGS}
# a box that cannot hold one r_cut cell a rank along each block axis
REFUSED = {"treepm_3d_small": ("treepm", AX3, 16)}
ADAPTIVE = ("direct", "pm", "direct_3d", "pm_2d", "direct_2d",
            "direct_reference_2d", "direct_reference_3d", "pm_3d")


def _config(solver: str, axes=None, ng: int = 16) -> dict:
    mesh = {"enabled": True}
    if axes:
        mesh["axes"] = axes
    return {"particles": {"num_particles": N, "box_size": BOX},
            "forces": {"type": solver, "softening_length": 0.5,
                       "pm_grid_size": ng},
            "time": {"initial_timestep": 1e-2, "final_time": 1e9},
            "cosmology": {"model": "Newtonian", "initial_redshift": 49.0},
            "simulation": {"output_frequency": 2, "checkpoint_frequency": 0},
            "units": {"system": "box", "G": 1.0, "H0_internal": 0.1},
            "compute": {"mesh": mesh},
            "profiling": {"output_file": ""}}


def _state():
    rng = np.random.default_rng(5)
    return {"pos": rng.uniform(0.0, BOX, (N, 3)).astype(np.float32),
            "vel": (5.0 * rng.normal(size=(N, 3))).astype(np.float32),
            "mass": rng.uniform(0.5, 1.5, N).astype(np.float32), "a": 0.5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's per-rank results) for every config."""
    st = _state()
    configs = {name: _config(*c) for name, c in CONFIGS.items()}
    finish = start_ranks(
        "engine", N_RANKS, tmp_path_factory.mktemp("pg"),
        {"configs": dict(configs, **{name: _config(*c)
                                     for name, c in GRID_ONLY.items()}),
         "refused": {name: _config(*c) for name, c in REFUSED.items()},
         "state": st, "steps": dict({name: STEPS for name in CONFIGS},
                                    **{name: 2 for name in GRID_ONLY}),
         "out_dir": str(tmp_path_factory.mktemp("ck"))})
    jax_out = {}
    for name, d in configs.items():
        eng = jlc.SimulationBuilder().with_config(
            jlc.SimulationConfig.from_dict(d)).with_initial_state(
            make_state(st["pos"], st["vel"], st["mass"],
                       scale_factor=st["a"])).build()
        assert eng._mesh is not None
        axes = CONFIGS[name][1]
        if axes and "shx" in axes:
            assert dict(eng._mesh.shape) == {"shx": 2, "shy": axes["shy"],
                                             "shz": axes.get("shz", 1)}
        eng.run(num_steps=STEPS)
        e = eng.compute_energy()
        jax_out[name] = {"pos": np.asarray(eng.state.positions),
                         "vel": np.asarray(eng.state.velocities),
                         "mass": np.asarray(eng.state.masses),
                         "step": int(eng.state.step),
                         "ke": float(e["kinetic"]),
                         "pe": float(e["potential"])}
    return jax_out, finish()


@pytest.mark.parametrize("solver", list(CONFIGS))
def test_mesh_engine_matches_jax(runs, solver):
    jax_out, port = runs
    ref = jax_out[solver]
    for r in port[1:]:                     # every rank gathers the same
        for k in ("pos", "vel", "mass"):
            np.testing.assert_array_equal(r[f"{solver}_{k}"],
                                          port[0][f"{solver}_{k}"])
    got = port[0]
    assert got[f"{solver}_step"] == ref["step"] == STEPS
    n_pad = int(np.ceil(1.5 * N / N_RANKS)) * N_RANKS
    assert got[f"{solver}_pos"].shape == ref["pos"].shape == (n_pad, 3)
    np.testing.assert_array_equal(got[f"{solver}_mass"], ref["mass"])
    assert np.sum(ref["mass"] > 0) == N
    assert np.abs(got[f"{solver}_pos"] - ref["pos"]).max() <= 1e-5 * BOX
    assert np.abs(got[f"{solver}_vel"] - ref["vel"]).max() <= \
        1e-4 * np.abs(ref["vel"]).max()
    for k in ("ke", "pe"):
        assert got[f"{solver}_{k}"] == pytest.approx(ref[k], rel=1e-5)


def test_mesh_grid_and_homing(runs):
    """Each config's grid, and where its rows are homed: direct and pm on
    load-adaptive bounds, the TreePM and pm_fast on uniform slabs and
    blocks (with compute.mesh.load_balancing on), both once homed and
    after the run's last migration."""
    import torch
    from lambda_cdm_tpu_torch.parallel.exchange import (find_owner,
                                                        find_owner_3d)
    _, port = runs
    got = port[0]
    for name, (_, axes, _) in dict(CONFIGS, **GRID_ONLY).items():
        dims = (2, axes["shy"], axes.get("shz", 1)) \
            if axes and "shx" in axes else (N_RANKS,)
        assert tuple(got[f"{name}_dims"]) == dims
        assert got[f"{name}_adaptive"] == (name in ADAPTIVE)
        if name in ADAPTIVE:
            continue
        for tag in ("0", ""):
            pos = torch.as_tensor(got[f"{name}_pos{tag}"])
            mass = got[f"{name}_mass{tag}"]
            owner = (find_owner_3d(pos, BOX, dims) if len(dims) == 3
                     else find_owner(pos, BOX, N_RANKS)).numpy()
            rank = np.arange(len(mass)) // (len(mass) // N_RANKS)
            live = mass > 0
            np.testing.assert_array_equal(owner[live], rank[live])


@pytest.mark.parametrize("name", sorted(GRID_ONLY))
def test_every_solver_runs_on_the_grids(runs, name):
    """direct, direct_reference, pm, pm_fast and treepm each run on the
    (2, 4, 1) and (2, 2, 2) grids (the port alone, 2 steps and the
    migration after them): every step taken,
    every particle kept with its mass, finite rows, the same rows on every
    rank."""
    _, port = runs
    got = port[0]
    for r in port[1:]:
        np.testing.assert_array_equal(r[f"{name}_pos"], got[f"{name}_pos"])
    assert got[f"{name}_step"] == 2
    mass = got[f"{name}_mass"]
    np.testing.assert_array_equal(np.sort(mass[mass > 0]),
                                  np.sort(_state()["mass"]))
    assert np.all(np.isfinite(got[f"{name}_pos"]))
    assert np.all(np.isfinite(got[f"{name}_vel"]))
    assert np.isfinite(got[f"{name}_pe"]) and got[f"{name}_ke"] > 0


def test_3d_treepm_refuses_a_small_box(runs):
    """treepm on the block grid with a box that cannot hold one r_cut cell
    a rank along each axis raises the JAX engine's ValueError (on every
    rank, before any force)."""
    _, port = runs
    for r in port:
        assert r["treepm_3d_small_error"].startswith("ValueError")
        assert "box too small" in r["treepm_3d_small_error"]


def test_particles_crossed_slabs(runs):
    """Migration between chunks moved particles: some particle's rank
    (its row block) after the run differs from its rank once homed before
    the first step (each particle named by its mass, unique here)."""
    _, port = runs
    m0, m1 = port[0]["direct_mass0"], port[0]["direct_mass"]
    n_loc = m0.shape[0] // N_RANKS
    rank0 = {m: i // n_loc for i, m in enumerate(m0) if m > 0}
    rank1 = {m: i // n_loc for i, m in enumerate(m1) if m > 0}
    assert len(rank0) == len(rank1) == N and rank0.keys() == rank1.keys()
    assert sum(rank0[m] != rank1[m] for m in rank0) > 0


def test_rank0_writes_the_global_checkpoint(runs):
    """Every rank's save_checkpoint names one file, which rank 0 wrote:
    the gathered global state in rank order, and the JAX package loads
    it."""
    from lambda_cdm_tpu.utils import checkpoint as jckpt
    _, port = runs
    paths = {r["direct_ckpt"] for r in port}
    assert len(paths) == 1
    st, _, stats = jckpt.load_checkpoint(paths.pop())
    for k, f in (("pos", "positions"), ("vel", "velocities"),
                 ("mass", "masses")):
        np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                      port[0][f"direct_{k}"])
    assert int(st.step) == STEPS and stats["total_steps"] == STEPS
