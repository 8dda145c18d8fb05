"""K3: TreePM short-range pair accelerations on cell buckets -- the CUDA
kernel csrc/short_range.cu with its plain PyTorch version (counterpart
of lambda_cdm_tpu/ops/pallas_short_range.py and every `variant` of its
pallas_short_range).

Per live slot i of cell c:
    acc_i = sum over the 27 periodic neighbour cells n of c, over the
            live j of n, of m_j w(r) dx,
    dx = x_j + shift_n - x_i, r^2 = |dx|^2 + eps^2.
The shift is +-box where the neighbour's cell index wraps: positions
drift unwrapped between rebuckets, so periodicity comes from cell
indices, not from min-image. Dead slots get exactly 0.

The variant selects the split function w (the TPU variants' other
differences are lane tilings, which the kernel does not carry over):

* vpu3, vpu4, vpu4b, vpu5 -- even polynomial in r^2 (`_poly_even_coeffs`):
  w = c1 max(r^-3 + Q(min(r^2 v_scale - 1, 1)), 0). Live-first buckets:
  the live slots of cell c are 0..counts[c]-1.
* vpu2 -- endpoint-factored in r (`_poly_r_coeffs`): t = min(r, r_max)
  t_scale - 1, w = (1 - t) h(t) r^-3.
* vpu, mxu -- Horner in x = r / (2 rs) on forces.treepm._fit_short_poly's
  coefficients: w = where(x < x_max, max(S(x), 0), 0) r^-3. mxu is the
  vpu function (its TPU form is a GEMM on centred coordinates).

The kernel reads live-first counts in every split form. vpu, vpu2 and
mxu may be given none, as on the TPU: then any slot order is taken and a
slot with mass 0 is dead (the wrapper moves each cell's live slots first
before the launch and puts the results back).

The kernel's work is a list of units, each at most UNIT_ROWS live rows of
one cell, heaviest first (unit_plan, built on the card from the counts;
unit_plan_plain is its plain version, plan_units decodes either).

The kernel culls: a unit runs the pairs only with the candidate j whose
squared distance to the bounding box of the unit's rows, plus eps^2, is
below keep_radius2 (r_max^2 and a margin, where every split form's
float32 weight is exactly 0), in candidate order, so its sums are the
uncut ones value for value. cull_counts_plain is the plain version of
its counters `k3_j_tested` and `k3_j_kept` (utils/profiling.py, counted
on the card while tracing is on).
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import cuda_build
from ..forces.treepm import _fit_short_poly
from ..utils import profiling

_X_COEFFS, _X_MAX = _fit_short_poly()

# variant -> split form; the kernel takes the form as a template argument
SPLITS = {"vpu3": "even", "vpu4": "even", "vpu4b": "even", "vpu5": "even",
          "vpu2": "factored", "vpu": "xpoly", "mxu": "xpoly"}
VARIANTS = tuple(SPLITS)
_SPLIT_ID = {"even": 0, "factored": 1, "xpoly": 2}
UNIT_ROWS = 32     # live rows a unit of K3 (kUnitRows in short_range.cu)
PLAN_HEADER = 4    # the plan's header (kHeader in short_range.cu)
# the cull's relative margin over r_max^2: it covers the card's
# rsqrt.approx (a few 1e-7) against the plain version's rsqrt
KEEP_MARGIN = 1e-4
# K3's device counters: candidate j tested and kept, summed over units
TALLY = ("k3_j_tested", "k3_j_kept")

launches = {"short_range": 0, "short_range_vpu": 0, "short_range_vpu2": 0,
            "short_range_mxu": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


def counter(variant: str) -> str:
    """The launch-count key of a variant: the even-split variants share
    "short_range"."""
    return "short_range" if SPLITS[variant] == "even" \
        else f"short_range_{variant}"


def needs_counts(variant: str) -> bool:
    """Whether a variant must be given live-first counts (the even split);
    vpu, vpu2 and mxu also take none, with mass 0 as dead."""
    return SPLITS[variant] == "even"


@functools.lru_cache(maxsize=None)
def _poly_even_coeffs(rs: float, degree: int = 10):
    """Even-polynomial split in r^2, computed with numpy exactly as the
    JAX package does: (Q coefficients highest first, with c8/c1 folded in;
    v_scale; c1). Per pair w = (m c1) max(r^-3 + Q(min(r^2 v_scale - 1,
    1)), 0)."""
    x_max = _X_MAX
    u_max = x_max * x_max
    u = np.linspace(1e-8, u_max, 8001)
    x = np.sqrt(u)
    s = np.array([math.erfc(t) + (2.0 * t / math.sqrt(math.pi))
                  * math.exp(-t * t) for t in x])
    qt = (s - 1.0) / x ** 3
    v = 2.0 * u / u_max - 1.0
    c = np.polyfit(v, qt, degree)
    got = np.polyval(c.astype(np.float32), v.astype(np.float32))
    err = float(np.max(np.abs((got - qt) * x ** 3)))
    assert err < 2e-4, f"even split poly fit error {err}"
    s_end = (math.erfc(x_max) + (2.0 * x_max / math.sqrt(math.pi))
             * math.exp(-x_max * x_max))
    c1 = 1.0 - s_end
    c8 = 1.0 / (8.0 * rs ** 3)
    v_scale = 2.0 / (u_max * 4.0 * rs * rs)
    return ([float(cc * c8 / c1) for cc in c], float(v_scale), float(c1))


@functools.lru_cache(maxsize=None)
def _poly_r_coeffs(rs: float, degree: int = 11):
    """Endpoint-factored split in r, computed with numpy exactly as the JAX
    package does: S(r) - S(r_max) = (1 - t) h(t), t = 2 r / r_max - 1.
    Returns (h coefficients highest first, t_scale, r_max); per pair
    t = min(r, r_max) t_scale - 1, s = (1 - t) h(t)."""
    r_max = 2.0 * rs * _X_MAX
    r = np.linspace(0.0, r_max, 4001)[:-1]
    x = r / (2.0 * rs)
    s = np.array([math.erfc(v) + (2.0 * v / math.sqrt(math.pi))
                  * math.exp(-v * v) for v in x])
    s_end = (math.erfc(_X_MAX) + (2.0 * _X_MAX / math.sqrt(math.pi))
             * math.exp(-_X_MAX * _X_MAX))
    t = 2.0 * r / r_max - 1.0
    ch = np.polyfit(t, (s - s_end) / (1.0 - t), degree)
    got = (1.0 - t) * np.polyval(ch.astype(np.float32),
                                 t.astype(np.float32))
    err = float(np.max(np.abs(got - (s - s_end))))
    assert err < 1e-4, f"factored short poly fit error {err}"
    return [float(c) for c in ch], float(2.0 / r_max), float(r_max)


def _x_coeffs():
    """The x-space split polynomial (vpu, mxu): float32 coefficients
    highest first, as the TPU kernel unrolls them."""
    return [float(c) for c in _X_COEFFS]


def _split_params(variant: str, rs: float):
    """(coefficients highest first, p0, p1, mass scale) of a variant's
    split form: even (v_scale, unused, c1), factored (t_scale, r_max, 1),
    xpoly (1 / (2 rs), x_max, 1)."""
    form = SPLITS[variant]
    if form == "even":
        chq, v_scale, c1 = _poly_even_coeffs(rs)
        return chq, v_scale, 0.0, c1
    if form == "factored":
        ch, t_scale, r_max = _poly_r_coeffs(rs)
        return ch, t_scale, r_max, 1.0
    return _x_coeffs(), 1.0 / (2.0 * rs), float(_X_MAX), 1.0


def _validate(bpos, bmass, counts, ncell, capacity, softening, variant):
    if variant not in SPLITS:
        raise ValueError(f"unknown short-range variant {variant!r} (one of "
                         f"{', '.join(VARIANTS)})")
    if ncell < 3:
        raise ValueError("short_range needs ncell >= 3")
    if softening <= 0:
        raise ValueError("softening must be > 0")
    cc = ncell ** 3
    if tuple(bpos.shape) != (3, cc, capacity):
        raise ValueError(f"bpos must be SoA [3, {cc}, {capacity}], got "
                         f"{tuple(bpos.shape)}")
    if tuple(bmass.shape) != (cc, capacity):
        raise ValueError(f"bmass must be [{cc}, {capacity}]")
    if needs_counts(variant) and counts is None:
        raise ValueError(f"counts must be [{cc}] for variant {variant!r}")
    if counts is not None and tuple(counts.shape) != (cc,):
        raise ValueError(f"counts must be [{cc}]")


def _neighbours(cells, ncell, box_size):
    """[T] cell ids -> ([T, 27] neighbour cell ids, [3, T, 27] shifts)."""
    nc = ncell
    offs = torch.tensor([(ox, oy, oz) for ox in (-1, 0, 1)
                         for oy in (-1, 0, 1) for oz in (-1, 0, 1)],
                        device=cells.device)
    cxyz = torch.stack([cells // (nc * nc), (cells // nc) % nc, cells % nc])
    raw = cxyz[:, :, None] + offs.T[:, None, :]               # [3, T, 27]
    shift = torch.where(raw < 0, -box_size,
                        torch.where(raw >= nc, box_size, 0.0))
    n = torch.remainder(raw, nc)
    return (n[0] * nc + n[1]) * nc + n[2], shift.to(torch.float32)


def _horner(coeffs, x):
    out = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        out = out * x + c
    return out


def pair_weight(r2, variant: str, rs: float):
    """The split weight of each pair (to be multiplied by m_j times the
    mass scale of _split_params, then by dx), in the kernel's float32
    operation order."""
    coeffs, p0, p1, _ = _split_params(variant, float(rs))
    inv_r = torch.rsqrt(r2)
    inv_r3 = (inv_r * inv_r) * inv_r
    form = SPLITS[variant]
    if form == "even":
        v = torch.clamp(r2 * p0 - 1.0, max=1.0)
        return torch.clamp(inv_r3 + _horner(coeffs, v), min=0.0)
    r = r2 * inv_r
    if form == "factored":
        t = torch.clamp(r, max=p1) * p0 - 1.0
        return ((1.0 - t) * _horner(coeffs, t)) * inv_r3
    x = r * p0
    s = torch.where(x < p1, torch.clamp(_horner(coeffs, x), min=0.0), 0.0)
    return s * inv_r3


def keep_radius2(variant: str, rs: float) -> float:
    """K3's cull radius, squared (float32): r_max^2 (1 + KEEP_MARGIN),
    r_max = 2 rs x_max. Past r_max every split form's float32 weight is
    exactly 0 in the kernel's operation order (even: v clamps at 1 and
    Q(1) < -r_max^-3; factored: t clamps at exactly 1; xpoly: the
    select), as tests/test_torch_short_range.py checks for each form.
    Pairs inside the margin are evaluated, and weigh 0. All three forms
    end at the same radius, so `variant` does not move it."""
    r_max = 2.0 * rs * float(_X_MAX)
    return float(np.float32(r_max * r_max * (1.0 + KEEP_MARGIN)))


def live_slots(bmass, counts):
    """[C, K] live mask: the first counts[c] slots, or without counts the
    slots of positive mass."""
    if counts is not None:
        k = bmass.shape[1]
        return torch.arange(k, device=bmass.device)[None, :] < counts[:, None]
    return bmass > 0


def short_range_plain(bpos, bmass, counts, *, ncell: int, capacity: int,
                      box_size: float, rs: float, softening: float,
                      variant: str = "vpu3", rows=None, chunk: int = 0):
    """Plain PyTorch K3. Without `rows`: [3, C, K] for every slot (0 on
    dead slots; only the live rows are evaluated). With `rows` ([T] flat
    slot indices into C*K): [3, T] for those slots only, O(T * 27 * K) --
    the affordable comparison at full size (the counterpart of
    forces/treepm.short_range_targets, with the variant's split function).
    Evaluated in row chunks of `chunk` (default: about 8M pair slots per
    chunk). `counts` may be None for vpu, vpu2 and mxu (mass 0 dead)."""
    _validate(bpos, bmass, counts, ncell, capacity, softening, variant)
    mscale = _split_params(variant, float(rs))[3]
    soft2 = float(softening) ** 2
    cc, k = ncell ** 3, capacity
    chunk = chunk or max(16, (1 << 23) // (27 * k))
    flat_pos = bpos.reshape(3, cc * k)
    live_slot = live_slots(bmass, counts)
    all_rows = rows is None
    if all_rows:
        rows = torch.nonzero(live_slot.reshape(-1))[:, 0]
    rows = torch.as_tensor(rows, device=bpos.device).to(torch.int64)
    jmass = torch.where(live_slot, bmass, 0.0) * mscale
    out = torch.zeros((3, rows.numel()), dtype=torch.float32,
                      device=bpos.device)
    for r0 in range(0, rows.numel(), chunk):
        r = rows[r0:r0 + chunk]
        cells = r // k
        ncid, shift = _neighbours(cells, ncell, box_size)       # [T, 27]
        pi = flat_pos[:, r]                                     # [3, T]
        pj = bpos[:, ncid] + shift[..., None]                   # [3,T,27,K]
        d = pj - pi[:, :, None, None]
        r2 = d[0] * d[0] + (d[1] * d[1] + (d[2] * d[2] + soft2))
        w = jmass[ncid] * pair_weight(r2, variant, rs)
        acc = torch.sum(w[None] * d, dim=(2, 3))                # [3, T]
        live_i = live_slot.reshape(-1)[r]
        out[:, r0:r0 + chunk] = torch.where(live_i[None], acc, 0.0)
    if all_rows:
        full = torch.zeros((3, cc * k), dtype=torch.float32,
                           device=bpos.device)
        full[:, rows] = out
        return full.reshape(3, cc, k)
    return out


def neighbour_load(counts, ncell: int):
    """[C] live slots of each cell's 27 periodic neighbours (itself
    included): the j count of each of its rows."""
    c3 = counts.to(torch.int64).reshape(ncell, ncell, ncell)
    nbr = c3
    for ax in range(3):
        nbr = nbr + torch.roll(nbr, 1, ax) + torch.roll(nbr, -1, ax)
    return nbr.reshape(-1)


def unit_plan_plain(counts, ncell: int):
    """Plain PyTorch version of K3's plan (int32 [PLAN_HEADER + 3 C]):
    the header [0, L non-empty cells, U units, 0]; each cell's class
    floor(log2(neighbour load)), -1 when empty; the L non-empty cells
    ordered by class, heavy to light, then by cell id (the rest -1); the
    first unit of each of them (the rest -1). A cell of n live rows has
    ceil(n / UNIT_ROWS) units, numbered in that order."""
    cc = ncell ** 3
    n = counts.to(torch.int64)
    live = n > 0
    exp = torch.frexp(neighbour_load(counts, ncell).to(torch.float64))[1]
    cls = torch.where(live, exp.to(torch.int64) - 1, -1)
    cells = torch.nonzero(live)[:, 0]
    order = cells[torch.argsort(-cls[cells], stable=True)]
    nun = (n[order] + UNIT_ROWS - 1) // UNIT_ROWS
    ends = torch.cumsum(nun, 0)
    pad = torch.full((cc - order.numel(),), -1, dtype=torch.int64,
                     device=counts.device)
    header = torch.tensor([0, order.numel(), int(ends[-1]) if len(ends)
                           else 0, 0], device=counts.device)
    return torch.cat([header, cls, order, pad, ends - nun, pad]).to(
        torch.int32)


def unit_plan(counts, ncell: int):
    """K3's plan of units (see unit_plan_plain for its layout). CUDA
    counts launch the plan kernels of csrc/short_range.cu (no host sync;
    the order past the L non-empty cells is left unwritten); CPU counts
    take unit_plan_plain."""
    if counts.device.type == "cpu":
        return unit_plan_plain(counts, ncell)
    cuda_build.require_cuda("unit_plan", counts, dtypes=(torch.int32,))
    plan = torch.empty((PLAN_HEADER + 3 * ncell ** 3,), dtype=torch.int32,
                       device=counts.device)
    cuda_build.launch("lcdm_short_range_plan", counts.data_ptr(),
                      plan.data_ptr(), ncell)
    return plan


def plan_units(plan, counts, ncell: int):
    """Decode a plan on the host -> [U, 3] int64 (cell, first row, live
    rows) of each unit in the order the kernel's warps take them."""
    plan = plan.cpu().to(torch.int64)
    n = counts.cpu().to(torch.int64)
    cc = ncell ** 3
    n_live, n_units = int(plan[1]), int(plan[2])
    base = PLAN_HEADER + cc
    order = plan[base:base + n_live]
    first = plan[base + cc:base + cc + n_live]
    nun = torch.diff(torch.cat([first, torch.tensor([n_units])]))
    cell = torch.repeat_interleave(order, nun)
    row0 = (torch.arange(n_units) - torch.repeat_interleave(first, nun)) \
        * UNIT_ROWS
    return torch.stack([cell, row0, torch.clamp(n[cell] - row0,
                                                max=UNIT_ROWS)], dim=1)


def cull_counts_plain(bpos, counts, *, ncell: int, capacity: int,
                      box_size: float, softening: float, r2_keep: float,
                      chunk: int = 0):
    """Plain version of K3's cull counters: per unit of the plan (in
    plan_units' order), -> ([U] int64 candidate j tested, [U] int64 kept).
    A unit tests every live j of its 27 neighbour cells (shifted as K3
    shifts them) and keeps those with gx^2 + (gy^2 + (gz^2 + eps^2)) <
    r2_keep in float32, g the distance on each axis from the j to the
    bounding box of the unit's live rows. Evaluated in chunks of `chunk`
    units (default: about 16M candidate slots a chunk)."""
    units = plan_units(unit_plan_plain(counts.cpu(), ncell), counts, ncell)
    dev = bpos.device
    counts = counts.to(dev)
    kmax = max(int(counts.max()), 1)
    chunk = chunk or max(1, (1 << 24) // (27 * kmax))
    soft2 = float(softening) ** 2
    r2_keep = float(np.float32(r2_keep))
    lanes = torch.arange(UNIT_ROWS, device=dev)
    slots = torch.arange(kmax, device=dev)
    tested, kept = [], []
    for u0 in range(0, units.shape[0], chunk):
        cell, row0, rows = units[u0:u0 + chunk].to(dev).T
        live_i = lanes[None] < rows[:, None]                     # [u, 32]
        pi = bpos[:, cell[:, None],
                  torch.clamp(row0[:, None] + lanes, max=capacity - 1)]
        lo = torch.where(live_i, pi, math.inf).amin(-1)[..., None, None]
        hi = torch.where(live_i, pi, -math.inf).amax(-1)[..., None, None]
        ncid, shift = _neighbours(cell, ncell, box_size)         # [u, 27]
        pj = bpos[:, ncid, :kmax] + shift[..., None]       # [3, u, 27, kmax]
        g = torch.clamp(torch.maximum(lo - pj, pj - hi), min=0.0)
        d2 = g[0] * g[0] + (g[1] * g[1] + (g[2] * g[2] + soft2))
        live_j = slots < counts[ncid][..., None]
        tested.append(live_j.sum((1, 2)))
        kept.append((live_j & (d2 < r2_keep)).sum((1, 2)))
    if not tested:
        return (torch.zeros(0, dtype=torch.int64),) * 2
    return torch.cat(tested).cpu(), torch.cat(kept).cpu()


MAX_COEFFS = 12   # kMaxCoeffs in short_range.cu and short_range_rd.cu


@functools.lru_cache(maxsize=None)
def _host_coeffs(variant: str, rs: float):
    """The split's coefficients as the kernel takes them: a float32 host
    array of MAX_COEFFS, highest first, zero-padded."""
    q = _split_params(variant, rs)[0]
    return (ctypes.c_float * MAX_COEFFS)(*q, *[0.0] * (MAX_COEFFS - len(q)))


def short_range(bpos, bmass, counts, *, ncell: int, capacity: int,
                box_size: float, rs: float, softening: float,
                variant: str = "vpu3"):
    """Short-range accelerations (unit G) for every bucket slot -> SoA
    [3, C, K], 0 on dead slots. CUDA tensors launch K3
    (csrc/short_range.cu, replacing pallas_short_range's kernel of that
    variant: its plan from the counts, then the pair kernel, culling at
    keep_radius2 and, while tracing is on, counting into the device
    counters TALLY); CPU tensors take short_range_plain. `counts` ([C]
    int32, the live-first layout's occupancies) may be None for vpu, vpu2
    and mxu: then any slot order is taken and a slot of mass 0 is dead."""
    _validate(bpos, bmass, counts, ncell, capacity, softening, variant)
    if bpos.device.type == "cpu":
        return short_range_plain(bpos, bmass, counts, ncell=ncell,
                                 capacity=capacity, box_size=box_size,
                                 rs=rs, softening=softening, variant=variant)
    perm = None
    if counts is None:              # any slot order: move live slots first
        perm = torch.argsort((bmass <= 0).to(torch.uint8), dim=1,
                             stable=True)
        perm3 = perm[None].expand(3, -1, -1)
        bpos = torch.gather(bpos, 2, perm3)
        bmass = torch.gather(bmass, 1, perm)
        counts = torch.sum(bmass > 0, dim=1, dtype=torch.int32)
    cuda_build.require_cuda("short_range", bpos, bmass, counts,
                            dtypes=(torch.float32, torch.float32,
                                    torch.int32))
    out = _launch(bpos, bmass, counts, ncell=ncell, capacity=capacity,
                  box_size=box_size, rs=rs, softening=softening,
                  variant=variant, r2_keep=keep_radius2(variant, float(rs)),
                  tally=profiling.device_counters(TALLY, bpos.device))
    if perm is not None:
        out = torch.zeros_like(out).scatter_(2, perm3, out)
    return out


def _launch(bpos, bmass, counts, *, ncell, capacity, box_size, rs,
            softening, variant, r2_keep, tally=None):
    """K3's plan and pair kernel on live-first CUDA buckets, culling at
    `r2_keep` (+inf: the uncut kernel) and adding the j tested and kept
    to `tally` (int64 [2] on the card) where one is given."""
    _, p0, p1, mscale = _split_params(variant, float(rs))
    coeffs = _host_coeffs(variant, float(rs))
    plan = unit_plan(counts, ncell)
    out = torch.zeros_like(bpos)
    launches[counter(variant)] += 1
    cuda_build.launch("lcdm_short_range", bpos.data_ptr(), bmass.data_ptr(),
                      counts.data_ptr(), ctypes.addressof(coeffs),
                      plan.data_ptr(),
                      out.data_ptr(), ncell, capacity,
                      _SPLIT_ID[SPLITS[variant]], float(box_size),
                      float(softening) ** 2, p0, p1, mscale, float(r2_keep),
                      None if tally is None else tally.data_ptr())
    return out
