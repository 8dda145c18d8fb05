"""The port's mesh engine (compute.mesh.enabled on 8 spawned gloo ranks,
tests/_torch_mesh_worker.py) against the JAX engine's mesh run on the
conftest's 8 virtual CPU devices (its _init_mesh_path takes every
device), from one numpy state: direct (the ring) and pm (the sharded PM),
6 steps in chunks of 2, so the particles are homed on their slabs before
the first force and migrate after each chunk (load-adaptive bounds, the
emigrant-only exchange).

The gathered state is compared row for row: the same rows hold the same
particles (masses exactly, so every migration moved the same rows the
same way), positions to 1e-5 of the box and velocities to 1e-4 of the
largest (the stateless runs' bars), the energies to 1e-5.
"""

import numpy as np
import pytest

from _torch_mesh_worker import run_ranks

import lambda_cdm_tpu as jlc
from lambda_cdm_tpu.core.state import make_state

N_RANKS = 8
N, BOX, STEPS = 1024, 50.0, 6


def _config(solver: str) -> dict:
    return {"particles": {"num_particles": N, "box_size": BOX},
            "forces": {"type": solver, "softening_length": 0.5,
                       "pm_grid_size": 16},
            "time": {"initial_timestep": 1e-2, "final_time": 1e9},
            "cosmology": {"model": "Newtonian", "initial_redshift": 49.0},
            "simulation": {"output_frequency": 2, "checkpoint_frequency": 0},
            "units": {"system": "box", "G": 1.0, "H0_internal": 0.1},
            "compute": {"mesh": {"enabled": True}},
            "profiling": {"output_file": ""}}


def _state():
    rng = np.random.default_rng(5)
    return {"pos": rng.uniform(0.0, BOX, (N, 3)).astype(np.float32),
            "vel": (5.0 * rng.normal(size=(N, 3))).astype(np.float32),
            "mass": rng.uniform(0.5, 1.5, N).astype(np.float32), "a": 0.5}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's rank-0 result) for direct and pm."""
    st = _state()
    configs = {s: _config(s) for s in ("direct", "pm")}
    port = run_ranks("engine", N_RANKS, tmp_path_factory.mktemp("pg"),
                     {"configs": configs, "state": st, "steps": STEPS,
                      "out_dir": str(tmp_path_factory.mktemp("ck"))})
    jax_out = {}
    for name, d in configs.items():
        eng = jlc.SimulationBuilder().with_config(
            jlc.SimulationConfig.from_dict(d)).with_initial_state(
            make_state(st["pos"], st["vel"], st["mass"],
                       scale_factor=st["a"])).build()
        assert eng._mesh is not None
        eng.run(num_steps=STEPS)
        e = eng.compute_energy()
        jax_out[name] = {"pos": np.asarray(eng.state.positions),
                         "vel": np.asarray(eng.state.velocities),
                         "mass": np.asarray(eng.state.masses),
                         "step": int(eng.state.step),
                         "ke": float(e["kinetic"]),
                         "pe": float(e["potential"])}
    return jax_out, port


@pytest.mark.parametrize("solver", ["direct", "pm"])
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
