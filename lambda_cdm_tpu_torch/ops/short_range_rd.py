"""K8: the rod-dense TreePM short-range pair sum -- the CUDA kernel
csrc/short_range_rd.cu with its plain PyTorch version, and the rod-dense
packing and window tables it reads (counterpart of
lambda_cdm_tpu/ops/pallas_short_range_rd.py).

Particles are bucketed into ncell^2 rods (one per (cx, cy) cell column),
packed dense, z-sorted and live-first within each rod ([R, K_rod]).
Each rod's 16-row chunk t has 27 window-table entries (9 neighbour rods
x the main, +box and -box z segments); an entry packs
    start_tile * 1024 + ntiles * 4 + zsel
and covers the neighbour rod's slots [start_tile * 128, (start_tile +
ntiles) * 128), with the j z shifted by +box (zsel 1) or -box (zsel 2).
For each live slot i of chunk t:
    acc_i = sum over the chunk's 27 entries, over the slots j they
            cover, of (m_j c1) max(r^-3 + Q(min(r^2 v_scale - 1, 1)), 0) dx,
with the x/y shift from the neighbour rod's index wrapping, the z shift
from zsel, and Q the vpu3 even polynomial (short_range._poly_even_coeffs).
Dead i slots get 0.

Integer parity with the JAX package: the sort is stable (as jnp.argsort),
run starts come from torch.cummax, positions are divided by a 0-d tensor
on their own device (PyTorch's CUDA division by a Python scalar or a CPU
scalar multiplies by the reciprocal, which can move a cell or a quantized
z), and the tables' rank counts are torch.searchsorted on the z-sorted,
sentinel-tailed rods (the JAX package counts them by a [R, NCH, K_rod]
broadcast compare; the counts are equal).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import cuda_build
from .short_range import _host_coeffs, _poly_even_coeffs, pair_weight

CH = 16          # i rows a chunk (one table row)
SEGS = 3         # table entries per (chunk, neighbour rod)
ENT = 9 * SEGS
TILE = 128       # j slots a table tile
# chunks a work item of K8, a warp each: kGroup in csrc/short_range_rd.cu,
# which refuses another value (it sizes the plan)
GROUP = 8

launches = {"short_range_rd": 0}


def reset_launch_counts() -> None:
    launches["short_range_rd"] = 0


def rd_geometry(num_particles: int, ncell: int, *,
                headroom: float = 1.25) -> int:
    """K_rod: rod slot capacity, a multiple of 1024, headroom times the
    mean rod occupancy N / ncell^2 (the JAX package's rule)."""
    mean = num_particles / max(ncell * ncell, 1)
    k = int(math.ceil(headroom * mean))
    return max(1024, ((k + 1023) // 1024) * 1024)


def _zbits(ncell: int) -> int:
    """z quantization bits for the (rod, z) int32 sort key."""
    rbits = max(1, (ncell * ncell).bit_length())
    return min(21, 31 - rbits)


def _zq(z, box, zb: int):
    """Quantized z: trunc(z / box * 2^zb) clipped to [0, 2^zb - 1]."""
    return torch.clamp((z / box * (1 << zb)).to(torch.int32), 0,
                       (1 << zb) - 1)


def _box(positions, box_size):
    return torch.tensor(box_size, dtype=positions.dtype,
                        device=positions.device)


def rd_src_map(positions, masses, box_size, *, ncell: int, k_rod: int):
    """Rod-dense inverse slot map: (src [R*K_rod] int64, source row per
    slot or n for a dead slot; counts [R] int32 live per rod; overflow
    0-d int64). Slots within a rod are z-sorted on the quantized key and
    live-first."""
    n = positions.shape[0]
    dev = positions.device
    nrods = ncell * ncell
    box = _box(positions, box_size)
    cell = torch.clamp(torch.floor(positions / box * ncell).to(torch.int32),
                       0, ncell - 1)
    rod = cell[:, 0] * ncell + cell[:, 1]
    live = masses > 0
    zb = _zbits(ncell)
    key = torch.where(live, (rod << zb) + _zq(positions[:, 2], box, zb),
                      nrods << zb)

    order = torch.argsort(key, stable=True)
    live_s = live[order]
    rod_s = torch.where(live_s, rod[order], nrods)

    idx = torch.arange(n, device=dev)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = rod_s[1:] != rod_s[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - run_start
    ok = (rank < k_rod) & live_s
    nslots = nrods * k_rod
    slot = torch.where(ok, rod_s.to(torch.int64) * k_rod + rank, nslots)
    overflow = torch.sum(~ok & live_s)

    src = torch.full((nslots + 1,), n, dtype=torch.int64, device=dev)
    src[slot] = order
    bounds = torch.searchsorted(
        rod_s, torch.arange(nrods + 1, dtype=rod_s.dtype, device=dev))
    counts = torch.clamp(torch.diff(bounds), max=k_rod).to(torch.int32)
    return src[:nslots], counts, overflow


def rd_gather(x, src, fill=0.0):
    """Gather a per-particle array into rod-dense slots (sentinel pad)."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=0)[src]


def rd_pack(positions, masses, box_size, *, ncell: int, k_rod: int):
    """One-call rod-dense packing: (rpos [R, K_rod, 3], rmass [R, K_rod],
    counts [R], rzq [R, K_rod] quantized z with the dead sentinel 2^zb,
    overflow, src)."""
    nrods = ncell * ncell
    src, counts, overflow = rd_src_map(positions, masses, box_size,
                                       ncell=ncell, k_rod=k_rod)
    zb = _zbits(ncell)
    zq = _zq(positions[:, 2], _box(positions, box_size), zb)
    rpos = rd_gather(positions, src).reshape(nrods, k_rod, 3)
    rmass = rd_gather(torch.where(masses > 0, masses, 0.0),
                      src).reshape(nrods, k_rod)
    rzq = rd_gather(zq, src, fill=1 << zb).reshape(nrods, k_rod)
    return rpos, rmass, counts, rzq, overflow, src


def _neighbour_rods(ncell: int, device):
    """[9, R] neighbour rod ids, in the tables' (dx, dy) order."""
    rid = torch.arange(ncell * ncell, device=device)
    cx, cy = rid // ncell, rid % ncell
    return torch.stack([((cx + dx) % ncell) * ncell + (cy + dy) % ncell
                        for dx in (-1, 0, 1) for dy in (-1, 0, 1)])


def rd_window_tables(rzq, counts, *, ncell: int, k_rod: int,
                     box_size: float, window: float):
    """Packed per-(rod, chunk, neighbour, segment) window table
    [R, K_rod/16, 27] int32 (see the module docstring). `rzq` holds the
    quantized z of every slot (dead slots the sentinel); `window` =
    r_cut + delta, valid while every particle's drift since the packing
    stays under delta / 2."""
    nrods = ncell * ncell
    nch = k_rod // CH
    zb = _zbits(ncell)
    scale = float(1 << zb) / box_size
    qmax = (1 << zb) - 1

    zc = rzq.reshape(nrods, nch, CH)
    live = zc <= qmax
    zmin = torch.amin(torch.where(live, zc, 2 ** 30), dim=2)
    zmax = torch.amax(torch.where(live, zc, -1), dim=2)
    has_live = torch.any(live, dim=2)
    wq = int(math.ceil(window * scale)) + 1
    z_lo = zmin - wq                        # [R, NCH] (may be < 0)
    z_hi = zmax + wq                        # (may be > qmax)

    # the 9 neighbour rods of every rod at once: one searchsorted over the
    # [9R, K_rod] stack of their z-sorted, sentinel-tailed quantized z for
    # the four bounds of every chunk, each count capped at the rod's live
    # slots (#live slots with zq < bound)
    nbr = _neighbour_rods(ncell, rzq.device).reshape(-1)      # [9R]
    nn = counts[nbr].to(torch.int64)[:, None]                 # [9R, 1]
    bounds = torch.cat([torch.clamp(z_lo, min=0),
                        torch.clamp(z_hi, max=qmax) + 1, z_hi - qmax,
                        z_lo + qmax + 1], dim=1)              # [R, 4 NCH]
    rank = torch.searchsorted(
        rzq[nbr].contiguous(),
        bounds.to(rzq.dtype).repeat(9, 1).contiguous())       # [9R, 4 NCH]
    s1, e1, e2, s3 = torch.minimum(rank, nn).reshape(
        9, nrods, 4, nch).unbind(2)                           # [9, R, NCH]

    def seg_entry(start, end):
        st = torch.div(start, 128, rounding_mode="floor")
        nt = torch.clamp(torch.div(end + 127, 128, rounding_mode="floor")
                         - st, min=0)
        return st, torch.where(end > start, nt, 0)

    st1, nt1 = seg_entry(s1, e1)
    st2, nt2 = seg_entry(torch.zeros_like(s1),
                         torch.where(z_hi > qmax, e2, 0))
    st3, nt3 = seg_entry(s3, torch.where(z_lo < 0, nn.reshape(9, nrods, 1),
                                         0))
    entries = torch.stack([torch.where(has_live, st1 * 1024 + nt1 * 4, 0),
                           torch.where(has_live, st2 * 1024 + nt2 * 4 + 1, 1),
                           torch.where(has_live, st3 * 1024 + nt3 * 4 + 2, 2)],
                          dim=-1)                             # [9, R, NCH, 3]
    return entries.permute(1, 2, 0, 3).reshape(nrods, nch, ENT).to(
        torch.int32)


def _validate(rpos, rmass, counts, tables, ncell, k_rod, softening):
    if ncell < 3:
        raise ValueError("short_range_rd needs ncell >= 3")
    if k_rod % 1024:
        raise ValueError("k_rod must be a multiple of 1024")
    if softening <= 0:
        raise ValueError("softening must be > 0")
    nrods = ncell * ncell
    shapes = ((rpos, (nrods, k_rod, 3), "rpos"),
              (rmass, (nrods, k_rod), "rmass"), (counts, (nrods,), "counts"),
              (tables, (nrods, k_rod // CH, ENT), "tables"))
    for t, shape, name in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")


def _decode(ent):
    """(zsel, ntiles, start_tile) of packed table entries."""
    return (torch.remainder(ent, 4),
            torch.remainder(torch.div(ent, 4, rounding_mode="floor"), 256),
            torch.div(ent, 1024, rounding_mode="floor"))


def short_range_rd_plain(rpos, rmass, counts, tables, *, ncell: int,
                         k_rod: int, box_size: float, rs: float,
                         softening: float, rows=None, chunk: int = 0):
    """Plain PyTorch K8. Without `rows`: [R, K_rod, 3] for every slot (0
    on dead slots). With `rows` ([T] flat slot indices into R*K_rod):
    [T, 3] for those slots. Each row tests every slot of its 9 neighbour
    rods for each of its chunk's 27 entries and keeps the covered ones,
    in row chunks of `chunk` (default: about 4M pair slots)."""
    _validate(rpos, rmass, counts, tables, ncell, k_rod, softening)
    c1 = _poly_even_coeffs(float(rs))[2]
    soft2 = float(softening) ** 2
    box = float(box_size)
    dev = rpos.device
    nrods = ncell * ncell
    chunk = chunk or max(1, (1 << 22) // (ENT * k_rod))
    live_slot = (torch.arange(k_rod, device=dev)[None, :]
                 < counts[:, None])                       # [R, K_rod]
    all_rows = rows is None
    if all_rows:
        rows = torch.nonzero(live_slot.reshape(-1))[:, 0]
    rows = torch.as_tensor(rows, device=dev).to(torch.int64)
    jm = rmass * c1
    nbr_of = _neighbour_rods(ncell, dev).T                 # [R, 9]
    rid = torch.arange(nrods, device=dev)
    cx, cy = rid // ncell, rid % ncell
    off = torch.tensor([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                       device=dev)
    rawx = cx[:, None] + off[:, 0]
    rawy = cy[:, None] + off[:, 1]
    shift_x = torch.where(rawx < 0, -box, torch.where(rawx >= ncell, box,
                                                      0.0))
    shift_y = torch.where(rawy < 0, -box, torch.where(rawy >= ncell, box,
                                                      0.0))
    j_idx = torch.arange(k_rod, device=dev)
    e_nbr = torch.arange(ENT, device=dev) // SEGS
    comp = [rpos[..., a].contiguous() for a in range(3)]   # [R, K_rod]
    flat = rpos.reshape(-1, 3)
    out = torch.zeros((rows.numel(), 3), dtype=torch.float32, device=dev)
    for r0 in range(0, rows.numel(), chunk):
        row = rows[r0:r0 + chunk]
        r, i = row // k_rod, row % k_rod
        zsel, nt, st = _decode(tables[r, i // CH])          # [T, 27]
        nbr = nbr_of[r][:, e_nbr]                           # [T, 27]
        zshift = torch.where(zsel == 1, -box,
                             torch.where(zsel == 2, box, 0.0))
        cover = ((j_idx >= (st * 128)[..., None])
                 & (j_idx < ((st + nt) * 128)[..., None]))  # [T, 27, K]
        pi = flat[row]                                      # [T, 3]
        dx = (comp[0][nbr] + shift_x[r][:, e_nbr][..., None]) \
            - pi[:, 0, None, None]
        dy = (comp[1][nbr] + shift_y[r][:, e_nbr][..., None]) \
            - pi[:, 1, None, None]
        dz = comp[2][nbr] - (pi[:, 2, None] + zshift)[..., None]
        r2 = dx * dx + (dy * dy + (dz * dz + soft2))
        f = pair_weight(r2, "vpu3", rs)
        w = torch.where(cover, jm[nbr] * f, 0.0)
        acc = torch.stack([torch.sum(w * d, dim=(1, 2))
                           for d in (dx, dy, dz)], dim=-1)  # [T, 3]
        live_i = live_slot.reshape(-1)[row]
        out[r0:r0 + chunk] = torch.where(live_i[:, None], acc, 0.0)
    if all_rows:
        full = torch.zeros((nrods * k_rod, 3), dtype=torch.float32,
                           device=dev)
        full[rows] = out
        return full.reshape(nrods, k_rod, 3)
    return out


def rd_plan_plain(counts, *, k_rod: int):
    """Plain PyTorch version of K8's plan: the work items (int64, r * (K_rod
    / (16 GROUP)) + g) of every group of GROUP consecutive 16-row chunks
    of a rod holding a live row, the full groups first, then the partial
    ones by live rows, most first (ties by item). The kernel's plan lists
    the same items in that order of live rows (ties in no fixed order)."""
    rows = GROUP * CH
    gpr = k_rod // rows
    c = torch.clamp(counts.to(torch.int64), max=k_rod)
    g = torch.arange(gpr, device=counts.device)
    live_rows = torch.clamp(c[:, None] - rows * g[None], 0, rows)  # [R, G]
    item = torch.arange(c.numel() * gpr, device=counts.device)
    keep = live_rows.reshape(-1) > 0
    key = (rows - live_rows.reshape(-1)) * item.numel() + item
    return item[keep][torch.argsort(key[keep])]


def rd_plan(counts, *, k_rod: int):
    """K8's plan for CUDA counts (no host sync): int32 [2 + R K_rod / (16
    GROUP)], the header [items, 0] then the items of rd_plan_plain (in the
    same order of live rows; ties in no fixed order), the rest unwritten.
    CPU counts take rd_plan_plain (the items alone)."""
    if counts.device.type == "cpu":
        return rd_plan_plain(counts, k_rod=k_rod)
    cuda_build.require_cuda("rd_plan", counts, dtypes=(torch.int32,))
    plan = torch.empty((2 + counts.numel() * (k_rod // (CH * GROUP)),),
                       dtype=torch.int32, device=counts.device)
    cuda_build.launch("lcdm_short_range_rd_plan", counts.data_ptr(),
                      plan.data_ptr(), counts.numel(), k_rod, GROUP)
    return plan


def short_range_rd(rpos, rmass, counts, tables, *, ncell: int, k_rod: int,
                   box_size: float, rs: float, softening: float):
    """Short-range accelerations (unit G) for every rod slot -> [R, K_rod,
    3], 0 on dead slots. CUDA tensors launch K8 (csrc/short_range_rd.cu,
    replacing pallas_short_range_rd's _rd_kernel: its plan of work items,
    then the pair kernel on GROUP chunks a block); CPU tensors take
    short_range_rd_plain."""
    _validate(rpos, rmass, counts, tables, ncell, k_rod, softening)
    if rpos.device.type == "cpu":
        return short_range_rd_plain(rpos, rmass, counts, tables, ncell=ncell,
                                    k_rod=k_rod, box_size=box_size, rs=rs,
                                    softening=softening)
    cuda_build.require_cuda("short_range_rd", rpos, rmass, counts, tables,
                            dtypes=(torch.float32, torch.float32,
                                    torch.int32, torch.int32))
    _, v_scale, c1 = _poly_even_coeffs(float(rs))
    # [R, K_rod] float4 (x, y, z, m c1): one 16-byte copy a j slot
    pts = torch.cat([rpos, (rmass * c1)[..., None]], dim=-1).contiguous()
    coeffs = _host_coeffs("vpu3", float(rs))
    plan = rd_plan(counts, k_rod=k_rod)
    out = torch.zeros_like(rpos)
    launches["short_range_rd"] += 1
    cuda_build.launch("lcdm_short_range_rd", pts.data_ptr(),
                      counts.data_ptr(), tables.data_ptr(),
                      ctypes.addressof(coeffs), plan.data_ptr(),
                      out.data_ptr(), ncell, k_rod, GROUP, float(box_size),
                      float(softening) ** 2, v_scale)
    return out
