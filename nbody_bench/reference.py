"""Plain reference of the port's force laws and comoving kick, and the
lower-precision control, for the benchmark's correctness check.

A configuration's `forces.type` chooses the law (`LAWS`, `law_of`); a
type with none is refused, so no configuration is checked against a law
it does not run. Each law is written out again here without the
program:

* treepm_fast (ops/fast_treepm._accel at commit 9aff8f2), long range:
  CIC deposit (cell-centred) of the mass density on the ng^3 mesh,
  phi_k = -4 pi rho_k exp(-k^2 rs^2) / (k^2 W_cic(k)^2), the
  fourth-order finite difference -(8 (phi[i+1] - phi[i-1]) - (phi[i+2] -
  phi[i-2])) / (12 h) on each axis, CIC-interpolated, times G; short
  range: every pair within the split's support (6 rs), m_j w(r) dx with
  r^2 = |dx|^2 + eps^2 and the even-polynomial split w = c1 max(r^-3 +
  Q(min(r^2 v - 1, 1)), 0) fitted to S(x) - S(3), S(x) = erfc(x) + 2x /
  sqrt(pi) exp(-x^2), x = r / (2 rs) (`even_split`: the port's fit,
  redone); times G. The pairs are found on a search grid of the
  reference's own (`search_grid`: cells no narrower than the support),
  so the force law does not follow the program's cell plan.
* pm_fast (the same stepper with pm_only): that long range unsplit
  (rs = 0), with no short range.
* pm (forces/pm.pm_accelerations): the unsplit PM with the spectral
  gradient: -i k phi_k, phi_k = -4 pi rho_k / (k^2 W_cic(k)^2), three
  inverse real FFTs, CIC-interpolated, times G.

`forces` evaluates a law in float64 for sampled targets against every
particle; `kdk` is the comoving kick-drift-kick step that moves them.
precision="tf32" is the control: the same sums with every pair
displacement, every pair weight and the mesh's density, potential and
(spectral) gradient fields rounded to TF32's 10-bit mantissa and the
rest in float32, the arithmetic a tensor-core formulation of the pair
sum or the mesh would do. It imports nothing of the program.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

X_MAX = 3.0              # the split's support, in units of 2 rs
PAIR_CHUNK = 1 << 24     # pairs evaluated at once

# forces.type -> its law: whether the PM carries the TreePM split, the
# PM's gradient, and whether the short-range pair sum is added
LAWS = {
    "treepm_fast": {"split": True, "gradient": "fd4", "short": True},
    "pm_fast": {"split": False, "gradient": "fd4", "short": False},
    "pm": {"split": False, "gradient": "spectral", "short": False},
}


def law_of(forces: dict) -> str:
    """The name of the law a configuration's `forces` block runs;
    ValueError where the reference states none for it (another type, a
    fast stepper's gradient other than fd4, modified gravity)."""
    kind = forces["type"]
    if kind not in LAWS:
        raise ValueError(f"forces.type {kind!r} has no law in the "
                         f"benchmark's reference (it has {sorted(LAWS)})")
    if kind.endswith("_fast") and forces.get("gradient", "fd4") != "fd4":
        raise ValueError(f"forces.type {kind!r} with gradient "
                         f"{forces['gradient']!r} has no law in the "
                         f"benchmark's reference (fd4 only)")
    if float(forces.get("modified_gravity_strength", 0.0)):
        raise ValueError("modified gravity has no law in the benchmark's "
                         "reference")
    return kind


def geometry(cfg: dict) -> dict:
    """What the law of a configuration (the port's SimulationConfig as a
    dict) reads: law, box, ng, rs and r_cut (from split_factor and
    cut_factor, also where the law has no split), softening, g_const,
    omega_m, omega_lambda."""
    f = cfg["forces"]
    box = float(cfg["particles"]["box_size"])
    ng = int(f["pm_grid_size"])
    rs = float(f["split_factor"]) * box / ng
    return {"law": law_of(f), "box": box, "ng": ng, "rs": rs,
            "r_cut": float(f["cut_factor"]) * rs,
            "softening": float(f["softening_length"]),
            "g_const": float(cfg["units"]["G"]),
            "omega_m": float(cfg["cosmology"]["omega_m"]),
            "omega_lambda": float(cfg["cosmology"]["omega_lambda"])}


@functools.lru_cache(maxsize=None)
def even_split(rs: float, degree: int = 10):
    """(Q coefficients highest first with c8 / c1 folded in, v_scale,
    c1): the least-squares fit the port's ops/short_range._poly_even_coeffs
    makes, in numpy, of (S(x) - 1) / x^3 on v = 2 u / u_max - 1."""
    u_max = X_MAX * X_MAX
    u = np.linspace(1e-8, u_max, 8001)
    x = np.sqrt(u)
    s = np.array([math.erfc(t) + (2.0 * t / math.sqrt(math.pi))
                  * math.exp(-t * t) for t in x])
    c = np.polyfit(2.0 * u / u_max - 1.0, (s - 1.0) / x ** 3, degree)
    s_end = (math.erfc(X_MAX) + (2.0 * X_MAX / math.sqrt(math.pi))
             * math.exp(-X_MAX * X_MAX))
    c1 = 1.0 - s_end
    c8 = 1.0 / (8.0 * rs ** 3)
    return (tuple(float(cc * c8 / c1) for cc in c),
            2.0 / (u_max * 4.0 * rs * rs), c1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits, to
    nearest)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def search_grid(box: float, rs: float) -> int:
    """Cells a side of the reference's pair search: the most whose width
    is at least the split's support, 2 X_MAX rs (at least 3)."""
    return max(3, int(box // (2.0 * X_MAX * rs)))


def cell_ids(pos, box: float, ncell: int):
    """[N] cell of each position, z-major, by the port's float32 rule
    floor(x / box * ncell) clamped to the grid."""
    p = pos.to(torch.float32)
    b = torch.tensor(box, dtype=torch.float32, device=p.device)
    c = torch.clamp(torch.floor(p / b * ncell).to(torch.int64), 0,
                    ncell - 1)
    return (c[:, 0] * ncell + c[:, 1]) * ncell + c[:, 2]


_OFFS = [(ox, oy, oz) for ox in (-1, 0, 1) for oy in (-1, 0, 1)
         for oz in (-1, 0, 1)]


def pair_chunks(p, cid, targets, *, ncell: int, box: float):
    """Every (target, source) pair of the 27 periodic neighbour cells of
    each target's cell, in chunks of about PAIR_CHUNK pairs: yields (t0,
    t1, ti, j, d) with the chunk's targets[t0:t1], each pair's target
    index into them, its source row, and dx = p[j] + shift - p[target]
    (shift +-box where the neighbour's cell index wraps), in p's dtype."""
    dev = p.device
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=ncell ** 3)
    start = torch.cumsum(counts, 0) - counts
    tcid = cid[targets]
    tc = torch.stack([tcid // (ncell * ncell), (tcid // ncell) % ncell,
                      tcid % ncell], dim=-1)
    raw = tc[:, None, :] + torch.tensor(_OFFS, device=dev)[None]
    shift = torch.where(raw < 0, -box,
                        torch.where(raw >= ncell, box, 0.0)).to(p.dtype)
    n3 = torch.remainder(raw, ncell)
    ncid = (n3[..., 0] * ncell + n3[..., 1]) * ncell + n3[..., 2]
    cnt = counts[ncid]                                          # [T, 27]
    bounds = torch.cumsum(cnt.sum(1), 0).cpu().numpy()
    t0 = 0
    while t0 < targets.numel():
        base = bounds[t0 - 1] if t0 else 0
        t1 = max(int(np.searchsorted(bounds, base + PAIR_CHUNK,
                                     side="right")), t0 + 1)
        c = cnt[t0:t1].reshape(-1)
        segs = torch.repeat_interleave(torch.arange(c.numel(), device=dev),
                                       c)
        local = (torch.arange(segs.numel(), device=dev)
                 - (torch.cumsum(c, 0) - c)[segs])
        j = order[start[ncid[t0:t1].reshape(-1)[segs]] + local]
        ti = segs // 27
        d = (p[j] + shift[t0:t1].reshape(-1, 3)[segs]
             - p[targets[t0:t1]][ti])
        yield t0, t1, ti, j, d
        t0 = t1


def short_range(pos, mass, targets, *, box: float, rs: float,
                softening: float, precision="float64", drop_cell=None,
                ncell=None):
    """Short-range accelerations (unit G) at pos[targets] -> [T, 3] over
    every pair within the split's support. `drop_cell` (a cell id of
    the search grid) leaves that cell's targets without their short
    range: a planted fault. `ncell` sums the 27 neighbour cells of
    another grid instead (a narrower one truncates the law)."""
    low = precision == "tf32"
    dt = torch.float32 if low else torch.float64
    ncell = ncell or search_grid(box, rs)
    cid = cell_ids(pos, box, ncell)
    p = pos.to(dt)
    m = mass.to(dt)
    coeffs, v_scale, c1 = even_split(float(rs))
    soft2 = float(softening) ** 2
    out = torch.zeros((targets.numel(), 3), dtype=dt, device=pos.device)
    for t0, t1, ti, j, d in pair_chunks(p, cid, targets, ncell=ncell,
                                        box=box):
        if low:
            d = tf32(d)
        r2 = (d * d).sum(-1) + soft2
        inv_r = torch.rsqrt(r2)
        v = torch.clamp(r2 * v_scale - 1.0, max=1.0)
        q = torch.full_like(v, coeffs[0])
        for cc in coeffs[1:]:
            q = q * v + cc
        w = c1 * torch.clamp(inv_r * inv_r * inv_r + q, min=0.0) * m[j]
        if low:
            w = tf32(w)
        out[t0:t1].index_add_(0, ti, w[:, None] * d)
    if drop_cell is not None:
        out[cid[targets] == drop_cell] = 0.0
    return out


def cic(pos, ng: int, box: float):
    """Cell-centred CIC: (the lower corner [N, 3] int64, the fraction
    [N, 3]) of each position on the ng^3 mesh."""
    u = pos * (ng / box) - 0.5
    f0 = torch.floor(u)
    return f0.to(torch.int64), u - f0


def corners(frac):
    """The 8 CIC corners: ((dx, dy, dz), weight [N])."""
    for off in itertools.product((0, 1), repeat=3):
        w = 1.0
        for ax, o in enumerate(off):
            w = w * (frac[:, ax] if o else 1.0 - frac[:, ax])
        yield off, w


def flat_index(i0, off, ng: int):
    """Flat periodic mesh index of i0 + off ([N, 3] -> [N])."""
    i = torch.remainder(i0 + torch.tensor(off, device=i0.device), ng)
    return (i[:, 0] * ng + i[:, 1]) * ng + i[:, 2]


def tf32_complex(z: torch.Tensor) -> torch.Tensor:
    """TF32 rounding of a complex tensor's real and imaginary parts."""
    return torch.complex(tf32(z.real), tf32(z.imag))


def pm_long_range(pos, mass, targets, *, box: float, ng: int, rs: float,
                  precision="float64", gradient="fd4", fault=None):
    """Long-range accelerations (unit G) at pos[targets] -> [T, 3]:
    the split exp(-k^2 rs^2) where rs > 0, the CIC window divided out
    twice (once where `fault` is "window_once", a planted fault), and
    the fd4 or the spectral gradient."""
    dev = pos.device
    low = precision == "tf32"
    dt = torch.float32 if low else torch.float64
    i0, frac = cic(pos.to(dt), ng, box)
    grid = torch.zeros(ng ** 3, dtype=dt, device=dev)
    for off, w in corners(frac):
        grid.index_add_(0, flat_index(i0, off, ng), w * mass.to(dt))
    grid = grid.reshape(ng, ng, ng) / (box / ng) ** 3
    if low:
        grid = tf32(grid)
    kf = torch.fft.fftfreq(ng, d=1.0 / ng, device=dev,
                           dtype=dt) * (2.0 * math.pi / box)
    kr = torch.fft.rfftfreq(ng, d=1.0 / ng, device=dev,
                            dtype=dt) * (2.0 * math.pi / box)
    kx, ky, kz = kf[:, None, None], kf[None, :, None], kr[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    half = box / ng / 2.0

    def sinc(kv):
        x = kv * half
        return torch.where(torch.abs(x) < 1e-12, 1.0,
                           torch.sin(x) / torch.where(x == 0, 1.0, x))

    win = (sinc(kx) * sinc(ky) * sinc(kz)) ** 2
    green = torch.where(k2 > 0, -4.0 * math.pi
                        / torch.where(k2 > 0, k2, 1.0), 0.0)
    green = green * torch.exp(-k2 * rs * rs) / (
        win if fault == "window_once" else win * win)
    ti0 = i0[targets]
    out = torch.zeros((targets.numel(), 3), dtype=dt, device=dev)
    s = (ng, ng, ng)
    if gradient == "spectral":
        phi_k = torch.fft.rfftn(grid) * green
        if low:
            phi_k = tf32_complex(phi_k)
        weights = [(flat_index(ti0, off, ng), w)
                   for off, w in corners(frac[targets])]
        for ax, kv in enumerate((kx, ky, kz)):
            field = torch.fft.irfftn(-1j * kv * phi_k, s=s).reshape(-1)
            if low:
                field = tf32(field)
            for flat, w in weights:
                out[:, ax] += w * field[flat]
        return out
    phi = torch.fft.irfftn(torch.fft.rfftn(grid) * green, s=s).reshape(-1)
    if low:
        phi = tf32(phi)
    inv_12h = ng / (12.0 * box)
    for off, w in corners(frac[targets]):
        for ax in range(3):
            def at(step):
                o = list(off)
                o[ax] += step
                return phi[flat_index(ti0, o, ng)]
            out[:, ax] += w * (-(8.0 * (at(1) - at(-1))
                                 - (at(2) - at(-2))) * inv_12h)
    return out


def forces(pos, mass, targets, *, geometry: dict, precision="float64",
           fault=None, ncell=None):
    """G (long + short range, as the law `geometry["law"]` has them) at
    pos[targets] -> [T, 3] (float64, or float32 for the control).
    `geometry`: law, box, ng, rs, softening, g_const (`geometry()`).
    Positions are wrapped into the box first. `fault`: None, "half"
    (every other particle left out, the rest at twice the mass),
    "window_once" (the CIC window divided out once, not twice) or
    ("drop_cell", a cell id of the search grid; a law with a short range
    only). `ncell`: as in short_range."""
    law = LAWS[geometry["law"]]
    pos = torch.remainder(pos.to(torch.float64), geometry["box"])
    if fault == "half":
        keep = (torch.arange(mass.numel(), device=mass.device) % 2) == 0
        mass = torch.where(keep, 2.0 * mass, 0.0)
    drop = fault[1] if isinstance(fault, tuple) else None
    if drop is not None and not law["short"]:
        raise ValueError(f"{geometry['law']} has no short range to drop")
    g = geometry
    long = pm_long_range(pos, mass, targets, box=g["box"], ng=g["ng"],
                         rs=g["rs"] if law["split"] else 0.0,
                         precision=precision, gradient=law["gradient"],
                         fault=fault)
    if not law["short"]:
        return g["g_const"] * long
    short = short_range(pos, mass, targets, box=g["box"], rs=g["rs"],
                        softening=g["softening"], precision=precision,
                        drop_cell=drop, ncell=ncell)
    return g["g_const"] * (long + short)


def rk4_scale_factor(a: float, dt: float, omega_m: float,
                     omega_lambda: float, h0_internal: float = 100.0):
    """a after dt of da/dt = a H(a), one RK4 step (the port's
    sf_method "rk4"), in float64."""
    def f(x):
        return x * h0_internal * math.sqrt(omega_m * x ** -3 + omega_lambda)
    k1 = f(a)
    k2 = f(a + 0.5 * dt * k1)
    k3 = f(a + 0.5 * dt * k2)
    k4 = f(a + dt * k3)
    return a + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def kdk(acc0, acc1, v0, *, a0: float, dt: float, omega_m: float,
        omega_lambda: float, drift_scale: float = 1.0):
    """One comoving KDK step from velocities v0 with the forces acc0 at
    its start and acc1 at its drifted positions -> (the change of the
    velocities, the drift) [T, 3]: half kicks acc / a dt / 2 at a0 and at
    the step's end a1, the drift v_half dt / a_half^2, a_half and a1 two
    RK4 half steps on. `drift_scale` scales the drift: a planted fault."""
    a_half = rk4_scale_factor(a0, 0.5 * dt, omega_m, omega_lambda)
    a1 = rk4_scale_factor(a_half, 0.5 * dt, omega_m, omega_lambda)
    v_half = v0 + 0.5 * dt * acc0 / a0
    return (0.5 * dt * (acc0 / a0 + acc1 / a1),
            drift_scale * v_half * dt / (a_half * a_half))
