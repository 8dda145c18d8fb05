"""Spawned gloo ranks for the port's multi-rank CPU tests.

`run_ranks(job, n_ranks, tmp_path, payload)` starts n_ranks processes
(torch.multiprocessing, spawn), each joining a gloo process group through
a file under tmp_path, builds the port's 1D mesh on the CPU (or on the
card, `device="cuda"`, the ranks sharing it), runs
JOBS[job](mesh, payload) and returns each rank's result (a dict of numpy
arrays and numbers), in rank order. A job may build the 3D grids it
needs (parallel.mesh.make_mesh3d) over the same ranks. This module imports torch and the
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
    # a grid that does not divide by the ranks: the whole grid on each
    for key, split in (("pm_whole", 0.0), ("pm_whole_split", 1.5)):
        out[key] = sharded.sharded_pm_accelerations(
            pos, mass, p["ng_whole"], box, p["g"], split_scale=split,
            mesh=mesh)
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
    global state p["state"] for p["steps"][name] steps: the gathered state
    after the run; for each config of p["refused"], the error its build
    raised."""
    import lambda_cdm_tpu_torch as tlc
    from lambda_cdm_tpu_torch.core.state import make_state

    def build(d):
        st = make_state(*(_t(p["state"][k])
                          for k in ("pos", "vel", "mass")),
                        scale_factor=p["state"]["a"])
        return tlc.SimulationBuilder(device="cpu").with_config(
            tlc.SimulationConfig.from_dict(d)).with_initial_state(st).build()

    out = {}
    for name, d in p.get("refused", {}).items():
        try:
            build(d)
            out[f"{name}_error"] = None
        except (ValueError, NotImplementedError) as exc:
            out[f"{name}_error"] = f"{type(exc).__name__}: {exc}"
    for name, d in p["configs"].items():
        eng = build(d)
        assert eng._mesh is not None and eng._mesh.size == mesh.size
        out[f"{name}_dims"] = eng._mesh.dims
        out[f"{name}_adaptive"] = eng._mesh_bounds is not None
        g0 = eng.state                               # rows once homed
        out[f"{name}_mass0"] = g0.masses
        out[f"{name}_pos0"] = g0.positions
        eng.run(num_steps=p["steps"][name])
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


def job_treepm(mesh, p) -> dict:
    """Every check of tests/test_torch_sharded_treepm.py on the 1D mesh:
    exchange_ghosts, the halo pass (its overflowing and zero-mass cases),
    the ring, and the full sharded TreePM (halo and ring-fallback
    geometries)."""
    from lambda_cdm_tpu_torch.parallel import exchange, sharded_treepm as stp
    box, soft, rs = p["box"], p["soft"], p["rs"]
    pos, mass = _rows(p["pos"], mesh), _rows(p["mass"], mesh)
    out = {}
    for name, (width, cap) in p["ghosts"].items():
        gp, gm, ovf = exchange.exchange_ghosts(
            pos, mass, box_size=box, ghost_width=width, capacity=cap,
            mesh=mesh)
        out.update({f"{name}_pos": gp, f"{name}_mass": gm,
                    f"{name}_overflow": ovf})
    m_dead = _rows(p["mass_dead"], mesh)
    for name, cap, m in (("halo", p["cap"], mass),
                         ("halo_ovf", p["cap_small"], mass),
                         ("halo_dead", p["cap"], m_dead)):
        acc, ovf = stp.halo_short_range_accelerations(
            pos, m, box_size=box, nc=p["nc"], capacity=cap, rs=rs,
            softening=soft, mesh=mesh)
        out.update({name: acc, f"{name}_overflow": ovf})
    out["ring"] = stp.ring_short_range_accelerations(
        pos, mass, box_size=box, rs=rs, softening=soft, mesh=mesh)
    for name, kw in (("full", dict(positions=pos, masses=mass,
                                   softening=soft, pm_grid=p["ng"])),
                     ("fallback", dict(positions=_rows(p["fb_pos"], mesh),
                                       masses=_rows(p["fb_mass"], mesh),
                                       softening=p["fb_soft"],
                                       pm_grid=p["fb_ng"]))):
        acc, diag = stp.sharded_treepm_accelerations(
            box_size=box, g_const=p["g"], mesh=mesh, return_diagnostics=True,
            **kw)
        out.update({name: acc, f"{name}_overflow": diag["overflow"],
                    f"{name}_plan": diag["plan"]})
    return {k: _np(v) for k, v in out.items()}


def job_block3d(mesh, p) -> dict:
    """Every check of tests/test_torch_block3d.py: on the (2, 2, 2) mesh
    the 3D migrations, the block halo pass and the full sharded TreePM; on
    the (2, 4, 1) pencil grid the ring direct sum and the TreePM."""
    from lambda_cdm_tpu_torch.parallel import exchange, sharded, \
        sharded_treepm as stp
    from lambda_cdm_tpu_torch.parallel.mesh import (axis_size, make_mesh2d,
                                                    make_mesh3d)
    box, soft, g = p["box"], p["soft"], p["g"]
    mesh3 = make_mesh3d((2, 2, 2), device=mesh.device)
    grid2 = make_mesh2d(device=mesh.device)        # the default shape
    me = torch.tensor([float(mesh.rank)])
    out = {"coords": mesh3.coords, "shape": mesh3.shape,
           "default3": make_mesh3d(device=mesh.device).dims,
           "grid2": grid2.shape,
           "grid2_from": [float(grid2.shift(me, a, s))
                          for a in grid2.axis_names for s in (1, -1)],
           "axis_size": [axis_size(mesh3, ("shx", "shy")), axis_size(mesh3),
                         axis_size(mesh3, "shz")]}
    mpos, mvel, mmass = (_rows(p[k], mesh3)
                         for k in ("mig_pos", "mig_vel", "mig_mass"))
    bounds = tuple(_t(b) for b in p["bricks"])
    for name, kw in (("full", dict(capacity=mpos.shape[0])),
                     ("emig", dict(capacity=p["cap_mig"])),
                     ("emig_bounds", dict(capacity=p["cap_mig"],
                                          bounds=bounds)),
                     ("emig_ovf", dict(capacity=p["cap_small"]))):
        fn = (exchange.migrate_particles if name == "full"
              else exchange.migrate_particles_emigrant)
        r = fn(mpos, mvel, mmass, box_size=box, mesh=mesh3, **kw)
        out.update({f"{name}_pos": r[0], f"{name}_vel": r[1],
                    f"{name}_mass": r[2], f"{name}_overflow": r[3]})
    pos, mass = _rows(p["pos3"], mesh3), _rows(p["mass3"], mesh3)
    for name, cap in (("halo", p["cap3"]), ("halo_ovf", p["cap_small"])):
        acc, ovf = stp.halo_short_range_accelerations_3d(
            pos, mass, box_size=box, nc=p["nc3"], capacity=cap, rs=p["rs"],
            softening=soft, mesh=mesh3)
        out.update({name: acc, f"{name}_overflow": ovf})
    acc, diag = stp.sharded_treepm_accelerations(
        pos, mass, box_size=box, pm_grid=p["ng"], softening=soft, g_const=g,
        mesh=mesh3, return_diagnostics=True)
    out.update({"full3": acc, "full3_overflow": diag["overflow"]})
    pencil = make_mesh3d((2, 4, 1), device=mesh.device)
    pos, mass = _rows(p["pos2"], pencil), _rows(p["mass2"], pencil)
    out["pencil_ring"] = sharded.ring_direct_accelerations(
        pos, mass, box_size=box, softening=p["soft2"], g_const=g,
        mesh=pencil)
    out["pencil_treepm"], diag = stp.sharded_treepm_accelerations(
        pos, mass, box_size=box, pm_grid=p["ng2"], softening=p["soft2"],
        g_const=g, mesh=pencil, return_diagnostics=True)
    out["pencil_overflow"] = diag["overflow"]
    return {k: _np(v) for k, v in out.items()}


def _fast_engine(p, name, d):
    """The port's engine on config d from p["states"][name], run for
    p["steps"][name] steps: the path it took, its capacity, the state in id
    order after the run, the counters and the energies."""
    import lambda_cdm_tpu_torch as tlc
    from lambda_cdm_tpu_torch.core.state import make_state
    s = p["states"][name]
    eng = tlc.SimulationBuilder(device="cpu").with_config(
        tlc.SimulationConfig.from_dict(d)).with_initial_state(make_state(
            *(_t(s[k]) for k in ("pos", "vel", "mass")),
            scale_factor=s["a"])).build()
    fast = eng._fast_mesh_kw is not None
    out = {f"{name}_fast_mesh": fast,
           f"{name}_grid": (eng._fast_mesh_2d, eng._fast_mesh_3d),
           f"{name}_stateless": eng._fstate is None
           and eng._accel_fn is not None and eng._mesh is not None,
           f"{name}_cap0": eng._fast_mesh_kw["capacity"] if fast else None}
    eng.run(num_steps=p["steps"][name])
    g = eng.state
    e = eng.compute_energy()
    out.update({f"{name}_pos": g.positions, f"{name}_vel": g.velocities,
                f"{name}_mass": g.masses, f"{name}_step": int(g.step),
                f"{name}_ke": float(e["kinetic"]),
                f"{name}_pe": float(e["potential"])})
    if fast:
        out.update({f"{name}_cap": eng._fast_mesh_kw["capacity"],
                    f"{name}_overflow": int(eng._fstate.overflow),
                    f"{name}_dropped": int(eng._fstate.dropped)})
    return out


def job_fast_mesh(mesh, p) -> dict:
    """Every check of tests/test_torch_fast_mesh.py on this group's ranks:
    mesh_fast_accel on each p["accel"] bucket set and mesh_rebucket on each
    p["rebucket"] case (global [C, K, ...] arrays, JAX's layout: each rank
    takes its cell range), the p["run"] stepper run from
    initialize_mesh_fast with its overflowing rebucket, and the engine
    configs p["engine"]. Slots come back as the rank's [Cl, K, ...]."""
    from lambda_cdm_tpu_torch.ops.fast_treepm import BucketOverflowError
    from lambda_cdm_tpu_torch.parallel import fast_mesh as fm
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    geo = p["geo"]
    kw = dict(box_size=geo["box"], ncell=geo["nc"], capacity=geo["cap"])

    def cells(x, dtype=torch.float32):
        n = x.shape[0] // mesh.size
        return _t(x[mesh.rank * n:(mesh.rank + 1) * n]).to(dtype)

    def soa(x):
        return cells(x).permute(2, 0, 1).contiguous()

    def aos(x):
        return x.permute(1, 2, 0)

    out = {}
    for name, (bpos, bmass) in p.get("accel", {}).items():
        acc, dropped = fm.mesh_fast_accel(
            soa(bpos), cells(bmass), mesh=mesh, ng=geo["ng"],
            margin=1, rs=geo["rs"], softening=geo["soft"], g_const=geo["g"],
            **kw)
        out.update({name: aos(acc), f"{name}_dropped": int(dropped)})
    for name, c in p.get("rebucket", {}).items():
        r = fm.mesh_rebucket(soa(c["bpos"]), soa(c["bvel"]),
                             cells(c["bmass"]), cells(c["ids"], torch.int32),
                             soa(c["acc"]), mesh=mesh,
                             mig_capacity=c["mig"], **kw)
        out.update({f"{name}_pos": aos(r[0]), f"{name}_vel": aos(r[1]),
                    f"{name}_mass": r[2], f"{name}_ids": r[3],
                    f"{name}_acc": aos(r[4]), f"{name}_overflow": int(r[5]),
                    f"{name}_migrated": int(r[6])})
    if "run" in p:
        run = p["run"]
        fs, fkw = fm.initialize_mesh_fast(
            _t(run["pos"]), _t(run["vel"]), _t(run["mass"]), run["a"],
            mesh=mesh, box_size=geo["box"], pm_grid=geo["ng"],
            softening=geo["soft"], plan_override=run.get("plan"),
            **run["kw"])
        out.update(run_kw=fkw, run_init_acc=aos(fs.acc),
                   run_init_ids=fs.ids, run_init_dropped=int(fs.dropped))
        params = CosmologyParams()
        end = fm.mesh_fast_run(fs, params, run["dt"], mesh=mesh,
                               n_steps=run["steps"], rebucket_every=4, **fkw)
        g = fm.gather_fast_state(end, mesh)
        out.update(run_ids=g.ids, run_pos=aos(g.bpos), run_vel=aos(g.bvel),
                   run_mass=g.bmass, run_step=int(end.step),
                   run_a=float(end.scale_factor),
                   run_overflow=int(end.overflow),
                   run_dropped=int(end.dropped))
        # a rebucket that would lose rows raises with the state it was
        # given, before any step
        live = (fs.bmass > 0) & (torch.arange(fs.bmass.shape[0])[:, None]
                                 < run["n_src"])
        tight = fs.replace(bpos=torch.where(live[None], 1.0, fs.bpos))
        try:
            fm.mesh_fast_run(tight, params, run["dt"], mesh=mesh, n_steps=1,
                             rebucket_every=1, steps_since_rebucket=1,
                             on_overflow="raise", **fkw)
            out["raised"] = None
        except BucketOverflowError as exc:
            same = all(torch.equal(getattr(exc.fstate, f), getattr(tight, f))
                       for f in ("bpos", "bvel", "bmass", "ids", "acc"))
            out["raised"] = (exc.steps_done, same)
    for name, d in p.get("engine", {}).items():
        out.update(_fast_engine(p, name, d))
    return {k: _np(v) for k, v in out.items()}


def job_pencil_fft(mesh, p) -> dict:
    """Every check of tests/test_torch_pencil_fft.py: the pencil FFT,
    its inverse and Poisson on the p["dims"] pencil grid (rank r's
    z-pencil of the global grid), the inverse of a non-Hermitian
    spectrum, and the axis collectives on the 3D grids of p["grids3"]:
    each rank's all_to_all of p["a2a"]'s chunks along each axis and axis
    tuple, and its axis_index."""
    from lambda_cdm_tpu_torch.parallel import fft
    from lambda_cdm_tpu_torch.parallel.mesh import make_mesh2d, make_mesh3d
    dx, dy = p["dims"]
    grid2 = make_mesh2d((dx, dy), device=mesh.device)
    ng, box = p["ng"], p["box"]
    ix, iy = grid2.coords
    xl, yl = ng // dx, ng // dy
    g = _t(p["grid"][ix * xl:(ix + 1) * xl, iy * yl:(iy + 1) * yl])
    gk = fft.pencil_rfftn(g, mesh=grid2)
    out = {"coords": grid2.coords, "rfftn": gk,
           "roundtrip": fft.pencil_irfftn(gk, ng=ng, mesh=grid2),
           "poisson": fft.pencil_poisson_solve(
               _t(p["rho"][ix * xl:(ix + 1) * xl, iy * yl:(iy + 1) * yl]),
               ng=ng, box_size=box, mesh=grid2),
           "poisson_split": fft.pencil_poisson_solve(
               _t(p["rho"][ix * xl:(ix + 1) * xl, iy * yl:(iy + 1) * yl]),
               ng=ng, box_size=box, mesh=grid2, split_scale=2.0)}
    spec = fft.pencil_block(_t(p["spectrum"]), grid2, ("shx", "shy"))
    out["irfftn_nonherm"] = fft.pencil_irfftn(spec.contiguous(), ng=ng,
                                              mesh=grid2)
    for name, dims in p["grids3"].items():
        g3 = make_mesh3d(tuple(dims), device=mesh.device)
        for axis in p["a2a_axes"]:
            key = "_".join(axis) if isinstance(axis, tuple) else axis
            n = 1
            for a in (axis if isinstance(axis, tuple) else (axis,)):
                n *= g3.shape[a]
            chunks = _t(p["a2a"][g3.rank][:n])
            out[f"{name}_a2a_{key}"] = g3.all_to_all(chunks, axis)
            out[f"{name}_index_{key}"] = g3.axis_index(axis)
    return {k: _np(v) for k, v in out.items()}


def job_fast_mesh_nd(mesh, p) -> dict:
    """Every check of tests/test_torch_fast_mesh2d.py (p["dims"] two
    ranks' counts) or tests/test_torch_fast_mesh3d.py (three): on the
    pencil or block grid of p["dims"], mesh_fast_accel* on each p["accel"]
    bucket set and mesh_rebucket* on each p["rebucket"] case (global
    block-major [C, K, ...] arrays, JAX's layout: rank r takes rows r Cl
    ... (r + 1) Cl), the p["run"] stepper run from initialize_mesh_fast*,
    its overflowing rebucket (raised with the state it was given) and the
    regrowth from the raised state, then the engine configs p["engine"].
    Slots come back as the rank's [Cl, K, ...]."""
    from lambda_cdm_tpu_torch.ops.fast_treepm import BucketOverflowError
    from lambda_cdm_tpu_torch.parallel import fast_mesh
    from lambda_cdm_tpu_torch.parallel.mesh import make_mesh2d, make_mesh3d
    from lambda_cdm_tpu_torch.physics.cosmology import CosmologyParams
    dims = tuple(p["dims"])
    if len(dims) == 2:
        from lambda_cdm_tpu_torch.parallel import fast_mesh2d as m
        grid = make_mesh2d(dims, device=mesh.device)
        accel, rebucket = m.mesh_fast_accel2d, m.mesh_rebucket2d
        init, run_fn = m.initialize_mesh_fast2d, m.mesh_fast_run2d
    else:
        from lambda_cdm_tpu_torch.parallel import fast_mesh3d as m
        grid = make_mesh3d(dims, device=mesh.device)
        accel, rebucket = m.mesh_fast_accel3d, m.mesh_rebucket3d
        init, run_fn = m.initialize_mesh_fast3d, m.mesh_fast_run3d
    r = grid.axis_index(grid.axis_names)
    geo = p["geo"]
    kw = dict(box_size=geo["box"], ncell=geo["nc"], capacity=geo["cap"])

    def cells(x, dtype=torch.float32):
        n = x.shape[0] // grid.size
        return _t(x[r * n:(r + 1) * n]).to(dtype)

    def soa(x):
        return cells(x).permute(2, 0, 1).contiguous()

    def aos(x):
        return x.permute(1, 2, 0)

    out = {"rank": r}
    for name, (bpos, bmass) in p.get("accel", {}).items():
        acc, dropped = accel(soa(bpos), cells(bmass), mesh=grid,
                             ng=geo["ng"], margin=1, rs=geo["rs"],
                             softening=geo["soft"], g_const=geo["g"], **kw)
        out.update({name: aos(acc), f"{name}_dropped": int(dropped)})
    for name, c in p.get("rebucket", {}).items():
        res = rebucket(soa(c["bpos"]), soa(c["bvel"]), cells(c["bmass"]),
                       cells(c["ids"], torch.int32), soa(c["acc"]),
                       mesh=grid, mig_capacity=c["mig"], **kw)
        out.update({f"{name}_pos": aos(res[0]), f"{name}_vel": aos(res[1]),
                    f"{name}_mass": res[2], f"{name}_ids": res[3],
                    f"{name}_acc": aos(res[4]),
                    f"{name}_overflow": int(res[5])})
    if "run" in p:
        run = p["run"]
        fs, fkw = init(_t(run["pos"]), _t(run["vel"]), _t(run["mass"]),
                       run["a"], mesh=grid, box_size=geo["box"],
                       pm_grid=geo["ng"], softening=geo["soft"],
                       **run["kw"])
        out.update(run_kw=fkw, run_init_acc=aos(fs.acc),
                   run_init_ids=fs.ids, run_init_dropped=int(fs.dropped),
                   run_init_overflow=int(fs.overflow))
        params = CosmologyParams()
        end = run_fn(fs, params, run["dt"], mesh=grid, n_steps=run["steps"],
                     rebucket_every=run["every"], **fkw)
        g = fast_mesh.gather_fast_state(end, grid)
        out.update(run_ids=g.ids, run_pos=aos(g.bpos), run_vel=aos(g.bvel),
                   run_mass=g.bmass, run_step=int(end.step),
                   run_a=float(end.scale_factor),
                   run_overflow=int(end.overflow),
                   run_dropped=int(end.dropped))
        # a rebucket that would lose rows raises with the state it was
        # given, before any step; the raised state regrows losslessly
        blob = cells(run["blob"])
        tight = fs.replace(bpos=torch.where(
            ~torch.isnan(blob[..., 0])[None], blob.permute(2, 0, 1),
            fs.bpos))
        try:
            run_fn(tight, params, 1e-5, mesh=grid, n_steps=1,
                   rebucket_every=1, steps_since_rebucket=1,
                   on_overflow="raise", **fkw)
            out["raised"] = None
        except BucketOverflowError as exc:
            same = all(torch.equal(getattr(exc.fstate, f), getattr(tight, f))
                       for f in ("bpos", "bvel", "bmass", "ids", "acc"))
            out["raised"] = (exc.steps_done, same)
            flat = fast_mesh.gather_fast_state(exc.fstate, grid)
            keep = flat.ids.reshape(-1) >= 0
            plan = {"ncell": fkw["ncell"], "capacity": run["regrow_cap"],
                    "margin": fkw["margin"], "rs": fkw["rs"]}
            # the regrowth is checked by its slots: the forces priming it
            # at the grown capacity (a 27 K^2 pair pass a cell, a minute
            # on these ranks) are left out
            primed = getattr(m, accel.__name__)
            setattr(m, accel.__name__, lambda bp, bm, **_: (
                torch.zeros_like(bp), torch.zeros((), dtype=torch.int32)))
            try:
                st, kw3 = init(flat.bpos.reshape(3, -1).T[keep],
                               flat.bvel.reshape(3, -1).T[keep],
                               flat.bmass.reshape(-1)[keep],
                               exc.fstate.scale_factor, mesh=grid,
                               box_size=geo["box"], pm_grid=geo["ng"],
                               softening=geo["soft"], plan_override=plan,
                               ids=flat.ids.reshape(-1)[keep], **run["kw"])
            finally:
                setattr(m, accel.__name__, primed)
            out.update(regrow_ids=st.ids, regrow_overflow=int(st.overflow),
                       regrow_cap=kw3["capacity"])
    for name, d in p.get("engine", {}).items():
        out.update(_fast_engine(p, name, d))
    return {k: _np(v) for k, v in out.items()}


JOBS = {"functions": job_functions, "engine": job_engine, "ring": job_ring,
        "treepm": job_treepm, "block3d": job_block3d,
        "fast_mesh": job_fast_mesh, "pencil_fft": job_pencil_fft,
        "fast_mesh_nd": job_fast_mesh_nd}


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


def start_ranks(job: str, n_ranks: int, tmp_path, payload,
                device: str = "cpu"):
    """Start the ranks of JOBS[job] and return `finish()`, which waits for
    them and returns each rank's result in rank order (the caller works
    meanwhile)."""
    import torch.multiprocessing as mp
    root = str(tmp_path)
    ctx = mp.start_processes(_rank_main,
                             args=(job, n_ranks, root, payload, device),
                             nprocs=n_ranks, join=False,
                             start_method="spawn")

    def finish() -> list:
        while not ctx.join():
            pass
        out = []
        for r in range(n_ranks):
            with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    return finish


def run_ranks(job: str, n_ranks: int, tmp_path, payload,
              device: str = "cpu") -> list:
    """Each rank's result of JOBS[job] computed on `device`, in rank
    order."""
    return start_ranks(job, n_ranks, tmp_path, payload, device)()
