"""The treepm_fast stepper in PyTorch (counterpart of
lambda_cdm_tpu/ops/fast_treepm.py): a persistent cell-bucketed state,
KDK steps whose force evaluation is

    K1 deposit -> FFT Poisson -> K2 fd4 gather   (long range)
    + K3 short-range pairs over 27 neighbour cells,

(or the PM alone, unsplit, with pm_only: forces.type="pm_fast"; the
spectral and interp gradients replace K2 with plain PyTorch gathers)

and a re-bucketing pass every `rebucket_every` steps outside the steps.
Drift beyond the deposit block margin is counted in `dropped`; bucket
overflow at a rebucket is counted in `overflow` (or raises, carrying
the last good state, with on_overflow="raise").

Layouts match the JAX package at every public function: SoA [3, C, K]
vectors, [C, K] masses and ids, z-major cell ids, live-first slots.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.state import host_scalar
from ..forces.treepm import bucket_gather, bucket_src_map
from ..physics.cosmology import CosmologyParams
from ..physics.integrators import (drift_factor, kick_factor,
                                   update_scale_factor, wrap_positions)
from ..utils.profiling import count, set_step, span
from .bucketed_pm import live_counts, pm_accelerations_bucketed
from .kdk_update import kdk_kick, kdk_open
from .rebucket import rebucket
from .short_range import short_range


@dataclasses.dataclass
class FastState:
    """Cell-bucketed simulation state (zero-mass padding).

    Per-slot arrays live on the simulation device. `scale_factor`,
    `time` (float32) and `step` (int32) are 0-d host tensors advanced by
    host arithmetic; `overflow` and `dropped` are 0-d int32 device
    tensors accumulated from the kernels without a host sync."""
    bpos: torch.Tensor           # [3, C, K]
    bvel: torch.Tensor           # [3, C, K]
    bmass: torch.Tensor          # [C, K]
    ids: torch.Tensor            # [C, K] int32 persistent ids (-1 pad)
    acc: torch.Tensor            # [3, C, K] accelerations at bpos
    scale_factor: torch.Tensor   # [] float32, host
    time: torch.Tensor           # [] float32, host
    step: torch.Tensor           # [] int32, host
    overflow: torch.Tensor       # [] int32 cumulative bucket overflow
    dropped: torch.Tensor        # [] int32 cumulative deposit-margin drops

    def replace(self, **kw) -> "FastState":
        return dataclasses.replace(self, **kw)


def fast_plan(num_particles: int, box_size: float, pm_grid: int, *,
              split_factor: float = 1.25, cut_factor: float = 4.5,
              capacity: int = 0, margin: int = 1,
              occupancy_headroom: float = 1.75) -> dict:
    """Static geometry, identical to the JAX fast_plan with
    align_ncell=False: ncell divides pm_grid with cells >= r_cut; the
    capacity and the `variant` name follow the JAX cost model (its
    128-slot quantization and the capacity-64 "vpu4b" pairing are TPU
    constraints kept here so both packages plan the same geometry; the
    CUDA short-range kernel takes any capacity, and `variant` selects
    only its split function: the planned vpu3/vpu4b/vpu5 share one)."""
    rs = split_factor * box_size / pm_grid
    r_cut = cut_factor * rs

    def cap_for(nc):
        if capacity > 0:
            return ((capacity + 127) // 128) * 128
        mean_occ = num_particles / max(nc ** 3, 1)
        c = int(math.ceil(occupancy_headroom * mean_occ))
        return max(128, ((c + 127) // 128) * 128)

    def paired_ok(nc):
        if capacity > 64 or nc % 2:
            return False
        mean_occ = num_particles / max(nc ** 3, 1)
        need = capacity if capacity > 0 else \
            math.ceil(occupancy_headroom * mean_occ)
        return need <= 64

    best = None
    best5 = None
    d = 2
    while d <= pm_grid:
        if pm_grid % d == 0 and box_size / d >= r_cut and d >= 3:
            cap = cap_for(d)
            if cap <= 128:
                cost = d ** 3 * 27 * cap * cap
                if best is None or cost < best[0]:
                    best = (cost, d, cap, "vpu3")
                if paired_ok(d):
                    pcost = d ** 3 * 64 * 18 * 128
                    if pcost < best[0]:
                        best = (pcost, d, 64, "vpu4b")
            else:
                occ = max(num_particles / d ** 3, 1.0)
                occ128 = 128 * math.ceil(occ / 128.0)
                cost = (num_particles * 27 * occ128
                        + d ** 3 * 27 * 128)
                state_b = d ** 3 * cap * 44
                over = state_b > 3.5 * 2 ** 30
                key5 = (over, cost)
                if best5 is None or key5 < best5[0]:
                    best5 = (key5, d, cap, "vpu5")
        d += 1
    if best is None:
        best = best5
    if best is None:
        # box too small for a 3^3 stencil: single-cell degenerate plan
        return {"rs": rs, "r_cut": r_cut, "ncell": 1,
                "capacity": cap_for(1), "margin": margin,
                "variant": "vpu3"}
    _, ncell, cap, variant = best
    return {"rs": rs, "r_cut": r_cut, "ncell": ncell,
            "capacity": cap, "margin": margin, "variant": variant}


def grown_plan(kw: dict, capacity: int) -> dict:
    """The plan of a stepper dict `kw` (initialize_fast's, or a sharded
    stepper's, which has no variant) rebuilt at a grown `capacity` by
    grow-and-retry: ncell, margin and rs kept, and the JAX engine's
    variant rule: above 128 slots vpu5, and a capacity other than 64
    leaves the vpu4b pairing."""
    variant = kw.get("variant", "vpu3")
    if capacity > 128:
        variant = "vpu5"
    elif variant == "vpu4b" and capacity != 64:
        variant = "vpu3"
    return {"ncell": kw["ncell"], "capacity": capacity,
            "margin": kw["margin"], "rs": kw["rs"], "variant": variant}


def build_fast_state(positions, velocities, masses, scale_factor, *,
                     box_size, plan, time=0.0, step=0,
                     ids=None) -> FastState:
    """Bucket a flat particle set ([N, 3] positions and velocities, [N]
    masses, all on one device) into the cell-list layout. `ids` are the
    persistent particle identities (default arange(N))."""
    ncell, cap = plan["ncell"], plan["capacity"]
    cc = ncell ** 3
    dev = positions.device
    src, _, _, _, ovf = bucket_src_map(
        positions, masses, box_size, ncell=ncell, capacity=cap)
    bpos = torch.stack([bucket_gather(positions[:, k], src)
                        .reshape(cc, cap) for k in range(3)])
    bmass = bucket_gather(masses, src).reshape(cc, cap)
    bvel = torch.stack([bucket_gather(velocities[:, k], src)
                        .reshape(cc, cap) for k in range(3)])
    if ids is None:
        ids = torch.arange(positions.shape[0], dtype=torch.int32,
                           device=dev)
    bids = bucket_gather(ids.to(torch.int32), src, -1).reshape(cc, cap)
    return FastState(
        bpos=bpos, bvel=bvel, bmass=bmass, ids=bids,
        acc=torch.zeros_like(bpos),
        scale_factor=host_scalar(scale_factor),
        time=host_scalar(time),
        step=host_scalar(step, torch.int32),
        overflow=ovf.to(torch.int32),
        dropped=torch.zeros((), dtype=torch.int32, device=dev))


def flatten_fast_state(fstate: FastState, with_ids: bool = False):
    """Back to flat (positions [S, 3], velocities [S, 3], masses [S]
    [, ids [S]]) with zero-mass padding rows (ids -1 there)."""
    pos = fstate.bpos.reshape(3, -1).T
    vel = fstate.bvel.reshape(3, -1).T
    out = (pos, vel, fstate.bmass.reshape(-1))
    return out + (fstate.ids.reshape(-1),) if with_ids else out


def _accel(fstate: FastState, *, box_size, ng, ncell, capacity, margin,
           rs, softening, g_const, gradient="fd4", pm_only=False,
           variant="vpu3", counts=None):
    """One force evaluation -> (acc [3, C, K], dropped 0-d int32): the
    PM long range (K1, FFT, K2 or the spectral/interp gradient) plus
    g_const times K3's short range in the split form of `variant`, added
    on live slots (kdk_update.kdk_kick with the scalars (g_const, 1),
    into the PM's output).
    pm_only: the unsplit PM alone (split_scale 0, no short range), the
    persistent-bucket PM solver of forces.type="pm_fast". `counts`: the
    live slots a bucket ([C] int32), derived from the masses when not
    given. Spans `fast.accel`, around the host's launches of the PM
    `fast.pm` and of K3 `fast.short_range`."""
    with span("fast.accel", device=fstate.bpos.is_cuda):
        if counts is None:
            counts = live_counts(fstate.bmass)
        with span("fast.pm"):
            acc_long, dropped = pm_accelerations_bucketed(
                fstate.bpos, fstate.bmass, ncell=ncell, ng=ng,
                box_size=box_size, g_const=g_const,
                split_scale=0.0 if pm_only else rs, margin=margin,
                gradient=gradient, counts=counts)
        if pm_only:
            return acc_long, dropped
        with span("fast.short_range"):
            acc_short = short_range(
                fstate.bpos, fstate.bmass, counts, ncell=ncell,
                capacity=capacity, box_size=float(box_size), rs=float(rs),
                softening=float(softening), variant=variant)
        return kdk_kick(acc_long, acc_short, counts, s1=g_const,
                        s2=1.0), dropped


def rebucket_pass(fstate: FastState, kw: dict) -> FastState:
    """One rebucket pass (`_rebucket`) with the keys it takes from
    initialize_fast's dict `kw` (n_rows 0 where the dict has none)."""
    return _rebucket(fstate, box_size=kw["box_size"], ncell=kw["ncell"],
                     capacity=kw["capacity"], n_rows=kw.get("n_rows", 0))


def _rebucket(fstate: FastState, *, box_size, ncell, capacity,
              n_rows: int = 0) -> FastState:
    """Re-bucketing, with positions wrapped here, where cells are
    re-derived. On the card (CUDA tensors) one pass over live rows only
    (ops/rebucket.py) for either layout; elsewhere the plain forms: the
    gather form (the JAX _rebucket's), or with `n_rows` (the particle
    count) and a sparse layout (C*K > 4 n_rows, as grow-and-retry and
    the science plan leave it) the compact form, which compacts the live
    slots to n_rows rows first, so its sort and gathers cost O(n_rows),
    not O(C*K). All three order each cell's particles by their old slot,
    so with n_rows at least the live rows (or 0) they give identical
    states, bit for bit."""
    bshape = fstate.bmass.shape
    if fstate.bpos.is_cuda:
        if capacity != bshape[1]:
            raise ValueError(f"_rebucket: capacity {capacity} is not the "
                             f"layout's {bshape[1]}")
        pos, vel, acc, mass, ids, grew = rebucket(
            fstate.bpos, fstate.bvel, fstate.acc, fstate.bmass, fstate.ids,
            box_size=box_size, ncell=ncell, n_rows=n_rows)
        return fstate.replace(bpos=pos, bvel=vel, acc=acc, bmass=mass,
                              ids=ids, overflow=fstate.overflow + grew)
    if n_rows and bshape[0] * bshape[1] > 4 * n_rows:
        return _rebucket_compact(fstate, box_size=box_size, ncell=ncell,
                                 capacity=capacity, n_rows=n_rows)
    return _rebucket_gather(fstate, box_size=box_size, ncell=ncell,
                            capacity=capacity)


def _rebucket_gather(fstate: FastState, *, box_size, ncell,
                     capacity) -> FastState:
    """The gather rebucket (the JAX _rebucket's dense form): one stable
    sort of every slot's cell and row gathers."""
    bshape = fstate.bmass.shape
    s = bshape[0] * bshape[1]
    pos3, mass = _wrapped_rows(fstate, box_size)
    shape = fstate.bpos.shape
    src, _, _, _, overflow = bucket_src_map(
        pos3, mass, box_size, ncell=ncell, capacity=capacity)

    def gather3(x):
        x = x.reshape(3, s)
        return torch.stack([bucket_gather(x[k], src)
                            for k in range(3)]).reshape(shape)

    return fstate.replace(
        bpos=gather3(pos3), bvel=gather3(fstate.bvel),
        acc=gather3(fstate.acc),
        bmass=bucket_gather(mass, src).reshape(bshape),
        ids=bucket_gather(fstate.ids.reshape(s), src, -1).reshape(bshape),
        overflow=fstate.overflow + overflow.to(torch.int32))


def _wrapped_rows(fstate: FastState, box_size):
    """(positions [3, S] wrapped into the box, 0 on dead slots; masses
    [S]) of the flat slots."""
    s = fstate.bmass.numel()
    pos3 = torch.where((fstate.bmass > 0)[None],
                       wrap_positions(fstate.bpos, box_size),
                       0.0).reshape(3, s)
    return pos3, fstate.bmass.reshape(s)


def _rebucket_compact(fstate: FastState, *, box_size, ncell, capacity,
                      n_rows: int) -> FastState:
    """The compact rebucket (JAX fast_treepm._rebucket's sparse branch):
    the first n_rows live slots (padded with the sentinel S) are bucketed
    alone, and every array is scattered to its new slot, overflow to a
    trash row S that is sliced off."""
    bshape = fstate.bmass.shape
    s = bshape[0] * bshape[1]
    pos3, mass = _wrapped_rows(fstate, box_size)
    count("readbacks")
    live_idx = torch.nonzero(mass > 0)[:n_rows, 0]
    pad = torch.full((n_rows - live_idx.numel(),), s, dtype=live_idx.dtype,
                     device=live_idx.device)
    live_idx = torch.cat([live_idx, pad])
    cpos3 = torch.stack([bucket_gather(pos3[k], live_idx) for k in range(3)])
    src, slot, order, ok, overflow = bucket_src_map(
        cpos3, bucket_gather(mass, live_idx), box_size, ncell=ncell,
        capacity=capacity)
    dest = torch.where(ok, slot, s)
    take = live_idx[order]

    def scat(vals, fill=0.0):
        out = torch.full((s + 1,), fill, dtype=vals.dtype,
                         device=vals.device)
        out[dest] = bucket_gather(vals, take, fill)
        return out[:s]

    def scat3(x):
        x = x.reshape(3, s)
        return torch.stack([scat(x[k]) for k in range(3)]).reshape(
            fstate.bpos.shape)

    return fstate.replace(
        bpos=scat3(pos3), bvel=scat3(fstate.bvel), acc=scat3(fstate.acc),
        bmass=scat(mass).reshape(bshape),
        ids=scat(fstate.ids.reshape(s), -1).reshape(bshape),
        overflow=fstate.overflow + overflow.to(torch.int32))


class BucketOverflowError(RuntimeError):
    """A re-bucketing pass would drop particles (cell occupancy exceeded
    the bucket capacity). Carries the last good state (before the lossy
    rebucket) and how many of the requested steps it completed, so the
    caller can re-plan with a larger capacity and continue losslessly."""

    def __init__(self, fstate: FastState, steps_done: int):
        super().__init__(
            "bucket capacity exceeded during rebucket; grow capacity "
            "and retry from the carried state")
        self.fstate = fstate
        self.steps_done = steps_done


def next_rebucket_offset(steps_since_rebucket: int, n_steps: int,
                         rebucket_every: int) -> int:
    """Closed form of fast_run's final steps-since-rebucket counter."""
    if n_steps <= 0:
        return max(0, int(steps_since_rebucket))
    s0 = int(steps_since_rebucket)
    s0 = s0 if 0 <= s0 < rebucket_every else 0
    return (s0 + n_steps - 1) % rebucket_every + 1


def fast_run(fstate: FastState, params: CosmologyParams, dt, *,
             rebucket_every: int = 16, n_steps: int = 1,
             on_overflow: str = "drop",
             steps_since_rebucket: int = 0, **kw) -> FastState:
    """Advance `n_steps` KDK steps: segments of `rebucket_every` steps
    with a re-bucketing pass between segments. `steps_since_rebucket`
    carries the cadence across calls (compute the next value with
    `next_rebucket_offset`). on_overflow="raise" aborts before accepting
    a lossy rebucket with a BucketOverflowError carrying the intact
    pre-rebucket state; "drop" counts the overflow and zero-masses the
    particles that did not fit. `kw` is initialize_fast's dict (either
    package's): the geometry, the integration knobs, `variant`, `pm_only`
    and `n_rows` (the rows bucketed, 0 for all: on the card it sizes the
    rebucket pass's sort; on the CPU a sparse layout takes the compact
    form with it, any other the gather form). A rebucket pass, with its
    overflow check (on the card one readback of the pass's overflow; the
    plain forms read both totals), is the span `fast.rebucket` and counts
    in `rebuckets`."""
    remaining = n_steps
    since = max(0, int(steps_since_rebucket))
    seg_kw = {k: v for k, v in kw.items() if k != "n_rows"}
    while remaining > 0:
        if since >= rebucket_every:
            count("rebuckets")
            with span("fast.rebucket", device=fstate.bpos.is_cuda):
                rb = rebucket_pass(fstate, kw)
                if on_overflow == "raise":
                    if rb.bpos.is_cuda:     # the card's pass: one wait
                        count("readbacks")
                        lossy = int(rb.overflow - fstate.overflow) > 0
                    else:
                        count("readbacks", 2)
                        lossy = int(rb.overflow) > int(fstate.overflow)
                    if lossy:
                        raise BucketOverflowError(fstate,
                                                  n_steps - remaining)
            fstate = rb
            since = 0
        seg = min(rebucket_every - since, remaining)
        fstate = _fast_segment(fstate, params, dt, n_steps=seg, **seg_kw)
        remaining -= seg
        since += seg
    return fstate


def _fast_segment(fstate: FastState, params: CosmologyParams, dt, *,
                  box_size: float, ng: int, ncell: int, capacity: int,
                  margin: int, rs: float, softening: float, g_const: float,
                  gradient: str = "fd4", h0_internal: float = 100.0,
                  kick_mode: str = "reference", sf_method: str = "rk4",
                  cosmological: bool = True, pm_only: bool = False,
                  variant: str = "vpu3", n_steps: int = 1) -> FastState:
    """Advance `n_steps` KDK steps with one force evaluation each (the
    closing half-kick force of one step opens the next), updating live
    slots only (ops/kdk_update.py). The live counts are taken once:
    slots change liveness only at a rebucket. The first step writes new
    buffers, so no tensor of `fstate` is written; later steps update the
    segment's own positions and velocities in place. Spans: the opening
    half kick and the drift, with the scale factor's update, `fast.drift`;
    the force `fast.accel`; the closing half kick `fast.kick`."""
    kw = dict(box_size=box_size, ng=ng, ncell=ncell, capacity=capacity,
              margin=margin, rs=rs, softening=softening, g_const=g_const,
              gradient=gradient, pm_only=pm_only, variant=variant)
    dt = float(dt)
    fs = fstate
    on_card = fs.bpos.is_cuda
    counts = live_counts(fs.bmass)
    for step in range(n_steps):
        set_step(fs.step)
        a0 = fs.scale_factor
        with span("fast.drift", device=on_card):
            if cosmological:
                a_half = update_scale_factor(params, a0, 0.5 * dt,
                                             h0_internal, sf_method)
                a1 = update_scale_factor(params, a_half, 0.5 * dt,
                                         h0_internal, sf_method)
            else:
                a_half, a1 = a0, a0
            # no box wrap between rebuckets: the kernels take positions
            # slightly outside the box (cell-index shifts, wrapped mesh
            # indices); positions wrap at rebucket time and on export
            pos, vel = kdk_open(
                fs.bpos, fs.bvel, fs.acc, counts, half_dt=0.5 * dt,
                kf=kick_factor(a0, kick_mode), dt=dt,
                df=drift_factor(a_half, kick_mode), owned=step > 0)
        fs = fs.replace(bpos=pos, bvel=vel, scale_factor=a1,
                        time=fs.time + dt, step=fs.step + 1)
        acc_new, dropped = _accel(fs, counts=counts, **kw)
        with span("fast.kick", device=on_card):
            vel = kdk_kick(fs.bvel, acc_new, counts, s1=0.5 * dt,
                           s2=kick_factor(a1, kick_mode))
        fs = fs.replace(bvel=vel, acc=acc_new,
                        dropped=fs.dropped + dropped)
    set_step(fs.step)
    return fs


def initialize_fast(positions, velocities, masses, scale_factor, *,
                    box_size, pm_grid, softening, g_const=43.0071057317063,
                    split_factor=1.25, cut_factor=4.5, margin=1,
                    capacity=0, gradient="fd4", time=0.0, step=0,
                    h0_internal=100.0, kick_mode="reference",
                    sf_method="rk4", cosmological=True, pm_only=False,
                    plan_override=None, ids=None):
    """Plan + bucket + prime accelerations. Returns (fstate, kw) ready for
    `fast_run`; kw holds the JAX initialize_fast dict's keys: the plan's
    `variant`, `pm_only` (the unsplit PM alone, forces.type="pm_fast")
    and `n_rows` (the rows given, for the rebucket). `plan_override`
    (`grown_plan`'s) and `ids` rebuild at a grown capacity with the
    geometry and the particle identities kept (grow-and-retry)."""
    plan = plan_override or fast_plan(
        positions.shape[0], float(box_size), pm_grid,
        split_factor=split_factor, cut_factor=cut_factor,
        capacity=capacity, margin=margin)
    if plan["ncell"] < 3 and not pm_only:
        raise ValueError("treepm_fast needs a box of at least 3 r_cut "
                         "cells per axis")
    with span("fast.build", device=positions.is_cuda):
        fstate = build_fast_state(positions, velocities, masses,
                                  scale_factor, box_size=box_size,
                                  plan=plan, time=time, step=step, ids=ids)
    accel_kw = dict(box_size=float(box_size), ng=pm_grid,
                    ncell=plan["ncell"], capacity=plan["capacity"],
                    margin=plan["margin"], rs=float(plan["rs"]),
                    softening=float(softening), g_const=float(g_const),
                    gradient=gradient, pm_only=bool(pm_only),
                    variant=plan.get("variant", "vpu3"))
    kw = dict(accel_kw, h0_internal=float(h0_internal),
              kick_mode=str(kick_mode), sf_method=str(sf_method),
              cosmological=bool(cosmological),
              n_rows=int(positions.shape[0]))
    acc, dropped = _accel(fstate, **accel_kw)
    fstate = fstate.replace(acc=acc, dropped=fstate.dropped + dropped)
    return fstate, kw
