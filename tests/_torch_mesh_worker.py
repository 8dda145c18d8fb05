"""Spawned gloo ranks for the port's multi-rank CPU tests.

`run_ranks(job, n_ranks, tmp_path, payload)` starts n_ranks processes
(torch.multiprocessing, spawn), each joining a gloo process group through
a file under tmp_path, builds the port's 1D mesh on the CPU (or on the
card, `device="cuda"`, the ranks sharing it), runs
JOBS[job](mesh, payload) and returns each rank's result (a dict of numpy
arrays and numbers), in rank order. This module imports torch and the
port only, so the ranks start without JAX.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _rows(x, mesh):
    n = x.shape[0] // mesh.size
    return _t(x[mesh.rank * n:(mesh.rank + 1) * n])


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def job_functions(mesh, p) -> dict:
    """Every function-level check of tests/test_torch_parallel.py."""
    from lambda_cdm_tpu_torch.parallel import exchange, fft, sharded
    box, soft, ng = p["box"], p["soft"], p["ng"]
    pos, vel, mass = (_rows(p[k], mesh) for k in ("pos", "vel", "mass"))
    out = {}
    out["ring"] = sharded.ring_direct_accelerations(
        pos, mass, box_size=box, softening=soft, g_const=p["g"], mesh=mesh)
    e = sharded.sharded_energy(pos, vel, mass, box_size=box, softening=soft,
                               g_const=p["g"], mesh=mesh)
    out.update({f"energy_{k}": v for k, v in e.items()})
    out["pm"] = sharded.sharded_pm_accelerations(pos, mass, ng, box,
                                                 p["g"], mesh=mesh)
    out["pm_split"] = sharded.sharded_pm_accelerations(
        pos, mass, ng, box, p["g"], split_scale=1.5, mesh=mesh)
    grid = _rows(p["grid"], mesh)
    gk = fft.distributed_rfftn(grid, mesh=mesh)
    out["rfftn"] = gk
    out["irfftn"] = fft.distributed_irfftn(_rows(p["spectrum_t"], mesh),
                                           ng=ng, mesh=mesh)
    # a gradient's spectrum: not Hermitian on the Nyquist planes
    kx = fft.k_vectors_transposed(ng, box, device="cpu")[0]
    out["irfftn_grad"] = fft.distributed_irfftn(
        -1j * kx * _rows(p["spectrum_t"], mesh), ng=ng, mesh=mesh)
    out["roundtrip"] = fft.distributed_irfftn(gk, ng=ng, mesh=mesh)
    out["poisson"] = fft.distributed_poisson_solve(grid, ng=ng, box_size=box,
                                                   mesh=mesh)
    out["poisson_split"] = fft.distributed_poisson_solve(
        grid, ng=ng, box_size=box, mesh=mesh, split_scale=2.0)
    bounds = _t(p["bounds"])
    mpos, mvel, mmass = (_rows(p[k], mesh)
                         for k in ("mig_pos", "mig_vel", "mig_mass"))
    for name, kw in (("emig", dict(capacity=p["cap"])),
                     ("emig_bounds", dict(capacity=p["cap"], bounds=bounds)),
                     ("emig_ovf", dict(capacity=p["cap_small"])),
                     ("full", dict(capacity=mpos.shape[0])),
                     ("full_ovf", dict(capacity=p["cap_small"]))):
        fn = (exchange.migrate_particles if name.startswith("full")
              else exchange.migrate_particles_emigrant)
        r = fn(mpos, mvel, mmass, box_size=box, mesh=mesh, **kw)
        out.update({f"{name}_pos": r[0], f"{name}_vel": r[1],
                    f"{name}_mass": r[2], f"{name}_ovf": r[3]})
    w = exchange.pair_cost_weights(mpos, mmass, box, mesh=mesh)
    out["pair_cost"] = w
    out["slab_bounds"] = exchange.adaptive_slab_bounds(
        mpos, mmass, mesh.size, box, mesh=mesh)
    out["slab_bounds_w"] = exchange.adaptive_slab_bounds(
        mpos, mmass, mesh.size, box, weights=w, mesh=mesh)
    bx, by, bz = exchange.adaptive_bounds_nd(mpos, mmass, (2, 2, 1), box,
                                             mesh=mesh)
    out.update(bounds_nd_x=bx, bounds_nd_y=by, bounds_nd_z=bz)
    out["imbalance"] = exchange.load_imbalance(mmass, mesh=mesh)
    out["imbalance_w"] = exchange.load_imbalance(mmass, mesh=mesh, weights=w)
    return {k: _np(v) for k, v in out.items()}


def job_engine(mesh, p) -> dict:
    """The port's mesh engine on each config of p["configs"] from the
    global state p["state"]: the gathered state after the run."""
    import lambda_cdm_tpu_torch as tlc
    from lambda_cdm_tpu_torch.core.state import make_state
    out = {}
    for name, d in p["configs"].items():
        st = make_state(*(_t(p["state"][k])
                          for k in ("pos", "vel", "mass")),
                        scale_factor=p["state"]["a"])
        eng = tlc.SimulationBuilder(device="cpu").with_config(
            tlc.SimulationConfig.from_dict(d)).with_initial_state(st).build()
        assert eng._mesh is not None and eng._mesh.size == mesh.size
        out[f"{name}_mass0"] = eng.state.masses      # rows once homed
        eng.run(num_steps=p["steps"])
        g = eng.state
        e = eng.compute_energy()
        # every rank calls it; rank 0 writes the gathered state
        out[f"{name}_ckpt"] = eng.save_checkpoint(
            os.path.join(p["out_dir"], name))
        out.update({f"{name}_pos": g.positions, f"{name}_vel": g.velocities,
                    f"{name}_mass": g.masses,
                    f"{name}_step": int(g.step),
                    f"{name}_ke": float(e["kinetic"]),
                    f"{name}_pe": float(e["potential"])})
    return {k: _np(v) for k, v in out.items()}


def job_ring(mesh, p) -> dict:
    """The ring's forces and energy and the sharded PM on the rank's
    device (the card test: each rank's kernels, gloo staging its tensors
    through the host)."""
    from lambda_cdm_tpu_torch.ops import direct
    from lambda_cdm_tpu_torch.parallel import sharded
    dev = mesh.device
    pos, vel, mass = (_rows(p[k], mesh).to(dev)
                      for k in ("pos", "vel", "mass"))
    direct.reset_launch_counts()
    acc = sharded.ring_direct_accelerations(
        pos, mass, box_size=p["box"], softening=p["soft"], g_const=p["g"],
        mesh=mesh)
    e = sharded.sharded_energy(pos, vel, mass, box_size=p["box"],
                               softening=p["soft"], g_const=p["g"],
                               mesh=mesh)
    pm = sharded.sharded_pm_accelerations(pos, mass, p["ng"], p["box"],
                                          p["g"], mesh=mesh)
    out = {"acc": acc, "pm": pm, "device": str(acc.device),
           "transport": mesh.transport, **dict(direct.launches)}
    out.update({f"energy_{k}": float(v) for k, v in e.items()})
    return {k: _np(v) for k, v in out.items()}


JOBS = {"functions": job_functions, "engine": job_engine, "ring": job_ring}


def _rank_main(rank: int, job: str, n_ranks: int, root: str, payload,
               device: str):
    torch.set_num_threads(1)
    from lambda_cdm_tpu_torch.parallel import mesh as tmesh
    tmesh.init_process_group(rank, n_ranks,
                             f"file://{os.path.join(root, 'pg')}")
    try:
        mesh = tmesh.make_mesh(device=device)
        result = JOBS[job](mesh, payload)
        with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(job: str, n_ranks: int, tmp_path, payload,
              device: str = "cpu") -> list:
    """Each rank's result of JOBS[job] computed on `device`, in rank
    order."""
    import torch.multiprocessing as mp
    root = str(tmp_path)
    mp.start_processes(_rank_main,
                       args=(job, n_ranks, root, payload, device),
                       nprocs=n_ranks, join=True, start_method="spawn")
    out = []
    for r in range(n_ranks):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
