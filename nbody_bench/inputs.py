"""The benchmark's start states: 2LPT initial conditions, the plain PM
evolution that clusters them, and the symmetry drawn from --seed.

`lpt_state` is a plain copy of lambda_cdm_tpu_torch/physics/
initial_conditions.py (gaussian_delta_k, displacement_from_delta,
second_order_displacement, lpt_displacements with kick_mode "comoving")
at commit 9aff8f2, with the white noise drawn from a torch.Generator.
`pm_evolve` is the benchmark's own particle-mesh run. Nothing here
imports the port, so the traffic does not move when the program does.

Every seed gets the same work in another order: the realisation is fixed
by the traffic file, and --seed draws one of the 48 signed axis
permutations of the periodic box and an order of the particles. The
forces are equivariant under both, and a signed permutation maps every
cubic cell grid onto itself, so every seed steps the same clustering
through the same bucket occupancies whatever plan the program makes.

The state before the seed's draw, and the time step the configuration's
rule takes on it, depend only on the configuration, the traffic and this
folder's code: they are kept in a cache file named by a hash of those
(under $XDG_CACHE_HOME, else in this folder's .cache), so that only the
first run in a checkout makes them.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os

import numpy as np
import torch

from . import cosmo as cm
from . import reference


def _fourier_grid(ng: int, box: float, device):
    kf = torch.fft.fftfreq(ng, d=1.0 / ng, device=device,
                           dtype=torch.float32) * (2.0 * math.pi / box)
    kr = torch.fft.rfftfreq(ng, d=1.0 / ng, device=device,
                            dtype=torch.float32) * (2.0 * math.pi / box)
    kx, ky, kz = kf[:, None, None], kf[None, :, None], kr[None, None, :]
    return kx, ky, kz, kx * kx + ky * ky + kz * kz


def _inv_k2(k2):
    return torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)


def lpt_state(cosmology: cm.Cosmology, *, n_side: int, ng: int, box: float,
              a_init: float, realisation: int, device):
    """2LPT positions and canonical velocities (v = a^2 dx/dt) of an
    n_side^3 lattice load from an ng^3 Gaussian field -> ([N, 3], [N, 3])
    float32 on `device`."""
    if ng % n_side:
        raise ValueError(f"IC grid {ng} must be a multiple of n_side "
                         f"{n_side}")
    gen = torch.Generator(device=device).manual_seed(int(realisation))
    white = torch.randn((ng, ng, ng), generator=gen, device=device,
                        dtype=torch.float32)
    kx, ky, kz, k2 = _fourier_grid(ng, box, device)
    k = torch.sqrt(k2).to(torch.float64)
    pk = torch.where(k2 > 0, cm.linear_power(cosmology,
                                             torch.clamp(k, min=1e-6)),
                     0.0).to(torch.float32)
    delta_k = (torch.fft.rfftn(white)
               * torch.sqrt(pk * float(ng) ** 3 / box ** 3)).to(
                   torch.complex64)
    del white
    inv_k2 = _inv_k2(k2)
    s = (ng, ng, ng)
    stride = ng // n_side

    def lattice(fields):
        return torch.stack([f[::stride, ::stride, ::stride].reshape(-1)
                            for f in fields], dim=-1)

    psi1 = lattice([torch.fft.irfftn(1j * kv * inv_k2 * delta_k, s=s)
                    for kv in (kx, ky, kz)])
    phi1_k = -delta_k * inv_k2

    def d2(ka, kb):
        return torch.fft.irfftn(-ka * kb * phi1_k, s=s)

    pxx, pyy, pzz = d2(kx, kx), d2(ky, ky), d2(kz, kz)
    source = pxx * pyy + pxx * pzz + pyy * pzz
    del pxx, pyy, pzz
    for ka, kb in ((kx, ky), (kx, kz), (ky, kz)):
        source = source - d2(ka, kb) ** 2
    s_k = torch.fft.rfftn(source)
    del source
    psi2 = lattice([torch.fft.irfftn(-1j * kv * inv_k2 * s_k, s=s)
                    for kv in (kx, ky, kz)])
    del s_k, delta_k, phi1_k

    d1 = cm.growth_factor(cosmology, a_init)
    om_a = cm.omega_m_a(cosmology, a_init)
    f1 = cm.growth_rate(cosmology, a_init)
    dd2 = -3.0 / 7.0 * om_a ** (-1.0 / 143.0) * d1 * d1
    f2 = 2.0 * om_a ** (6.0 / 11.0)
    vel_pref = cm.hubble(cosmology, a_init) * f1 * a_init * a_init
    idx = (torch.arange(n_side, dtype=torch.float32, device=device)
           + 0.5) * (box / n_side)
    q = torch.stack([g.reshape(-1) for g in
                     torch.meshgrid(idx, idx, idx, indexing="ij")], dim=-1)
    pos = torch.remainder(q + psi1 * d1 + psi2 * dd2, box)
    vel = vel_pref * psi1 * d1 + (vel_pref / f1) * f2 * psi2 * dd2
    return pos.to(torch.float32), vel.to(torch.float32)


def pm_accelerations(pos, mass: float, *, ng: int, box: float,
                     g_const: float):
    """Plain periodic PM: CIC deposit, -4 pi G / k^2 with the CIC window
    divided out twice, spectral gradient, CIC gather -> [N, 3]."""
    i0, frac = reference.cic(pos, ng, box)
    flats = [(reference.flat_index(i0, off, ng), w)
             for off, w in reference.corners(frac)]
    grid = torch.zeros(ng ** 3, dtype=torch.float32, device=pos.device)
    for flat, w in flats:
        grid.index_add_(0, flat, w * (mass / (box / ng) ** 3))
    rho_k = torch.fft.rfftn(grid.reshape(ng, ng, ng))
    del grid
    kx, ky, kz, k2 = _fourier_grid(ng, box, pos.device)
    half = box / ng / 2.0

    def sinc(kv):
        x = kv * half
        return torch.where(torch.abs(x) < 1e-12, 1.0, torch.sin(x) / x)

    win = (sinc(kx) * sinc(ky) * sinc(kz)) ** 2
    phi_k = rho_k * (-4.0 * math.pi * g_const * _inv_k2(k2) / (win * win))
    del rho_k
    acc = torch.zeros_like(pos)
    for ax, kv in enumerate((kx, ky, kz)):
        field = torch.fft.irfftn(-1j * kv * phi_k, s=(ng, ng, ng)).reshape(-1)
        for flat, w in flats:
            acc[:, ax] += w * field[flat]
        del field
    return acc


def pm_evolve(pos, vel, mass: float, cosmology: cm.Cosmology, *, box: float,
              a_start: float, a_end: float, ng: int, dloga: float,
              g_const: float):
    """KDK of the comoving canonical equations (dv = acc dt / a, dx = v
    dt / a^2, as the port integrates them) on the plain PM from a_start
    to a_end in equal steps of ln a no longer than `dloga`, with the kick
    and drift factors integrated exactly."""
    n = max(1, math.ceil(math.log(a_end / a_start) / dloga))
    grid = [a_start * (a_end / a_start) ** (k / n) for k in range(n + 1)]
    acc = pm_accelerations(pos, mass, ng=ng, box=box, g_const=g_const)
    for a0, a1 in zip(grid[:-1], grid[1:]):
        am = math.sqrt(a0 * a1)
        vel = vel + acc * cm.time_between(cosmology, a0, am, 1)
        pos = torch.remainder(pos + vel * cm.time_between(cosmology, a0, a1,
                                                          2), box)
        acc = pm_accelerations(pos, mass, ng=ng, box=box, g_const=g_const)
        vel = vel + acc * cm.time_between(cosmology, am, a1, 1)
    return pos, vel


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels (index_add_ without atomics) while the
    inputs are made, so one seed gives the same inputs bit for bit."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


HERE = os.path.dirname(os.path.abspath(__file__))
AMAX_CHUNK = 65536       # targets a reference call of the rule's |a|max
ETA = 0.25               # the rule's eta sqrt(eps / |a|max)


def rule_dt(cfg: dict, pos, mass, a: float) -> float:
    """The time step the configuration's rule takes at the state: the
    port's adaptive_dt (physics/integrators.py at commit 9aff8f2), min(
    time.initial_timestep, eta sqrt(eps / |a|max), max_dloga / H(a))
    clamped to [min_timestep, max_timestep], where the engine applies it
    (integration.adaptive_timestep or max_dloga > 0); otherwise the
    fixed time.initial_timestep. |a|max is the largest float64
    reference acceleration, in the law of the configuration's
    forces.type, over every particle."""
    integ, t = cfg["integration"], cfg["time"]
    dt = float(t["initial_timestep"])
    max_dloga = float(integ.get("max_dloga", 0.0))
    if not integ.get("adaptive_timestep") and max_dloga <= 0:
        return dt
    geometry = reference.geometry(cfg)
    n = pos.shape[0]
    masses = torch.full((n,), mass, dtype=torch.float32, device=pos.device)
    amax = 0.0
    for t0 in range(0, n, AMAX_CHUNK):
        targets = torch.arange(t0, min(t0 + AMAX_CHUNK, n),
                               device=pos.device)
        acc = reference.forces(pos, masses, targets, geometry=geometry)
        amax = max(amax, float(torch.max(torch.linalg.norm(acc, dim=1))))
    dt = min(dt, ETA * math.sqrt(geometry["softening"] / max(amax, 1e-30)))
    if max_dloga > 0:
        c = cfg["cosmology"]
        h = float(cfg["units"].get("H0_internal", 100.0)) * math.sqrt(
            float(c["omega_m"]) * a ** -3 + float(c["omega_lambda"]))
        dt = min(dt, max_dloga / h)
    return min(max(dt, float(integ["min_timestep"])),
               float(integ["max_timestep"]))


def cache_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME")
    return (os.path.join(base, "nbody_bench") if base
            else os.path.join(HERE, ".cache"))


def cache_key(cfg: dict, traffic: dict, device) -> str:
    """A hash of what the state before the seed's draw depends on."""
    h = hashlib.sha256()
    h.update(json.dumps([cfg, traffic], sort_keys=True).encode())
    for name in ("inputs.py", "cosmo.py", "reference.py"):
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(f.read())
    h.update(f"{torch.__version__} {torch.device(device).type}".encode())
    return h.hexdigest()[:32]


def base_state(cfg: dict, traffic: dict, device, cache=None) -> dict:
    """The state before the seed's draw: dict(pos, vel [N, 3] float32,
    mass, a, dt), made from the configuration and the traffic, or read
    from the cache directory `cache` (default `cache_dir()`, "" for
    none) where an earlier run made it."""
    cache = cache_dir() if cache is None else cache
    path = (os.path.join(cache, cache_key(cfg, traffic, device) + ".pt")
            if cache else None)
    if path and os.path.exists(path):
        return torch.load(path, map_location=device)
    cosmology = cm.Cosmology.from_config(cfg)
    n = int(cfg["particles"]["num_particles"])
    box = float(cfg["particles"]["box_size"])
    n_side = round(n ** (1.0 / 3.0))
    if n_side ** 3 != n:
        raise ValueError(f"2LPT needs a cubic particle number, got {n}")
    ic = cfg["particles"].get("initial_conditions", {})
    ng = max(int(ic.get("grid_size", n_side)), n_side)
    a_init = 1.0 / (1.0 + float(cfg["cosmology"]["initial_redshift"]))
    g_const = float(cfg.get("units", {}).get("G", 43.0071057317063))
    mass = cm.RHO_CRIT * cosmology.omega_m * box ** 3 / n
    with deterministic():
        pos, vel = lpt_state(cosmology, n_side=n_side, ng=ng, box=box,
                             a_init=a_init,
                             realisation=traffic["realisation"],
                             device=device)
        a = a_init
        evolve = traffic.get("evolve")
        if evolve:
            a = 1.0 / (1.0 + float(evolve["z_end"]))
            pos, vel = pm_evolve(pos, vel, mass, cosmology, box=box,
                                 a_start=a_init, a_end=a,
                                 ng=int(evolve["pm_grid"]),
                                 dloga=float(evolve["dloga"]),
                                 g_const=g_const)
        dt = rule_dt(cfg, pos, mass, a)
    st = {"pos": pos, "vel": vel, "mass": mass, "a": a, "dt": dt}
    if path:
        os.makedirs(cache, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(st, tmp)
        os.replace(tmp, path)
    return st


def symmetry(seed: int):
    """The seed's draw: (axis permutation, axis flips, the numpy
    generator it came from for later draws)."""
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    perm = rng.permutation(3)
    flips = rng.integers(0, 2, size=3)
    return perm, flips, rng


def apply_symmetry(pos, vel, *, box: float, perm, flips, order):
    """Signed axis permutation and particle order of a periodic state."""
    p = pos[:, perm]
    v = vel[:, perm]
    sign = torch.tensor([-1.0 if f else 1.0 for f in flips],
                        dtype=pos.dtype, device=pos.device)
    offset = torch.tensor([box if f else 0.0 for f in flips],
                          dtype=pos.dtype, device=pos.device)
    p = torch.remainder(p * sign + offset, box)
    return p[order].contiguous(), (v * sign)[order].contiguous()


def start_state(cfg: dict, traffic: dict, seed: int, device, cache=None):
    """The cell's start state: dict(pos, vel [N, 3] float32, mass (one
    particle's, 1e10 Msun/h), a, dt (the rule's step, held fixed), rng)
    on `device`. `cfg` is the configuration file, `traffic` the traffic
    file, `cache` as in `base_state`."""
    st = base_state(cfg, traffic, device, cache)
    n = st["pos"].shape[0]
    box = float(cfg["particles"]["box_size"])
    perm, flips, rng = symmetry(seed)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)
    order = torch.randperm(n, generator=gen, device=device)
    pos, vel = apply_symmetry(st["pos"], st["vel"], box=box, perm=perm,
                              flips=flips, order=order)
    return {"pos": pos, "vel": vel, "mass": st["mass"], "a": st["a"],
            "dt": st["dt"], "rng": rng}
