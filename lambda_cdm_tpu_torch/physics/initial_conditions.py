"""Cosmological initial conditions in PyTorch (counterpart of
lambda_cdm_tpu/physics/initial_conditions.py): Gaussian random fields,
Zel'dovich and 2LPT displacements, lattice, uniform and glass loads.

The white noise is drawn from a PRNG key with utils/prng, the JAX
package's jax.random stream: `generate_state` derives its keys as the
JAX package does, so a config gives the particles the JAX package gives
it. The noise may also come from a torch.Generator, or be passed in as a
tensor or array. Conventions as in the JAX package: box in Mpc/h, k in
h/Mpc, delta_k in rfftn layout, P(k) drawn at z=0 and scaled back with
the linear growth factor.
"""

from __future__ import annotations

import math

import torch

from .cosmology import CosmologyParams, as_f32, growth_factor, growth_rate, \
    omega_m_a
from .integrators import hubble_internal
from .power_spectra import TRANSFERS, linear_power
from ..core.state import SimState, make_state
from ..utils import prng

# critical density in (1e10 Msun/h) / (Mpc/h)^3 for H0=100 internal, G=43.007
RHO_CRIT = 27.753662724570805


def fourier_grid(ng: int, box_size: float, device="cuda"):
    """Wavevectors (kx, ky, kz, k2) for an rfftn-layout grid, float32, on
    `device` (the card unless named, as the JAX package's arrays go to
    its default device)."""
    two_pi = 2.0 * math.pi
    kf = torch.fft.fftfreq(ng, d=1.0 / ng, device=device,
                           dtype=torch.float32) * (two_pi / box_size)
    kr = torch.fft.rfftfreq(ng, d=1.0 / ng, device=device,
                            dtype=torch.float32) * (two_pi / box_size)
    kx = kf[:, None, None]
    ky = kf[None, :, None]
    kz = kr[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    return kx, ky, kz, k2


def white_noise(noise, ng: int, device=None) -> torch.Tensor:
    """[ng, ng, ng] float32 unit white noise on `device`: prng.normal of
    `noise` when it is a PRNG key (jax.random.normal's numbers; drawn on
    the card when no device is named), drawn from `noise` when it is a
    torch.Generator, else `noise` itself (a tensor or numpy array)."""
    if prng.is_key(noise):
        return prng.normal(noise, (ng, ng, ng),
                           device="cuda" if device is None else device)
    if isinstance(noise, torch.Generator):
        return torch.randn((ng, ng, ng), generator=noise,
                           device=noise.device, dtype=torch.float32
                           ).to(device)
    if isinstance(noise, torch.Tensor):
        white = noise.to(device=device, dtype=torch.float32)
    else:
        white = torch.tensor(noise, dtype=torch.float32, device=device)
    if tuple(white.shape) != (ng, ng, ng):
        raise ValueError(f"white noise must be {(ng,) * 3}, "
                         f"got {tuple(white.shape)}")
    return white


def _inv_k2(k2):
    return torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)


def gaussian_delta_k(noise, ng: int, box_size: float,
                     params: CosmologyParams,
                     transfer: str = "eisenstein_hu",
                     fixed_amplitude: bool = False, device=None):
    """Gaussian linear density field delta_k at z=0 in rfftn layout:
    rfftn(white noise) * sqrt(P(k) * ng^3 / V), Hermitian by construction."""
    volume = box_size ** 3
    white = white_noise(noise, ng, device)
    dk = torch.fft.rfftn(white)
    _, _, _, k2 = fourier_grid(ng, box_size, device=white.device)
    k = torch.sqrt(k2)
    t_fn = TRANSFERS[transfer] if isinstance(transfer, str) else transfer
    pk = linear_power(params, torch.clamp(k, min=1e-6), z=0.0, transfer=t_fn)
    pk = torch.where(k2 > 0, pk, 0.0)
    if fixed_amplitude:
        mag = torch.abs(dk)
        dk = torch.where(mag > 0, dk / torch.clamp(mag, min=1e-30), 0.0)
        dk = dk * torch.sqrt(pk * float(ng) ** 6 / volume)
    else:
        dk = dk * torch.sqrt(pk * float(ng) ** 3 / volume)
    return dk.to(torch.complex64)


def displacement_from_delta(delta_k, ng: int, box_size: float):
    """Zel'dovich displacement Psi_k = i k / k^2 delta_k in real space
    -> [3, ng, ng, ng]."""
    kx, ky, kz, k2 = fourier_grid(ng, box_size, device=delta_k.device)
    inv_k2 = _inv_k2(k2)
    psi = []
    for kvec in (kx, ky, kz):
        psi_k = 1j * kvec * inv_k2 * delta_k
        psi.append(torch.fft.irfftn(psi_k, s=(ng, ng, ng)))
    return torch.stack(psi)


def second_order_displacement(delta_k, ng: int, box_size: float):
    """Unit-growth 2LPT displacement [3, ng, ng, ng]: grad(phi2) with
    lap(phi2) = sum_{i<j} [phi1,ii phi1,jj - phi1,ij^2], lap(phi1) = delta
    (the JAX package's spectral form and sign convention)."""
    kx, ky, kz, k2 = fourier_grid(ng, box_size, device=delta_k.device)
    inv_k2 = _inv_k2(k2)
    phi1_k = -delta_k * inv_k2

    def d2(ka, kb):
        return torch.fft.irfftn(-ka * kb * phi1_k, s=(ng, ng, ng))

    pxx, pyy, pzz = d2(kx, kx), d2(ky, ky), d2(kz, kz)
    pxy, pxz, pyz = d2(kx, ky), d2(kx, kz), d2(ky, kz)
    source = (pxx * pyy + pxx * pzz + pyy * pzz
              - pxy * pxy - pxz * pxz - pyz * pyz)
    s_k = torch.fft.rfftn(source)
    psi2 = []
    for kvec in (kx, ky, kz):
        psi2.append(torch.fft.irfftn(-1j * kvec * inv_k2 * s_k,
                                     s=(ng, ng, ng)))
    return torch.stack(psi2)


def lattice_positions(n_side: int, box_size: float, device="cuda"):
    """Uniform grid particle load at cell centres -> [n^3, 3] on `device`
    (the card unless named)."""
    idx = (torch.arange(n_side, dtype=torch.float32, device=device)
           + 0.5) * (box_size / n_side)
    qx, qy, qz = torch.meshgrid(idx, idx, idx, indexing="ij")
    return torch.stack([qx.reshape(-1), qy.reshape(-1), qz.reshape(-1)],
                       dim=-1)


def _sample_field_at_lattice(field, n_side: int, ng: int):
    """Sample a [3, ng, ng, ng] field at an n_side^3 lattice -> [n^3, 3]."""
    if ng % n_side:
        raise ValueError(
            f"LPT IC grid ng={ng} must be a multiple of n_side="
            f"{n_side} (lattice sites must coincide with grid points; "
            f"a fractional stride would silently mis-sample)")
    stride = ng // n_side
    sub = field[:, ::stride, ::stride, ::stride]
    return sub.reshape(3, -1).T


def ic_velocity_prefactor(params: CosmologyParams, a, h0_internal: float,
                          kick_mode: str = "reference"):
    """Displacement -> integrator velocity: H f (times a^2 for comoving)."""
    a = as_f32(a)
    h = hubble_internal(params, a, h0_internal)
    f = growth_rate(params, a)
    pref = h * f
    if kick_mode == "comoving":
        pref = pref * a * a
    return pref


def lpt_displacements(noise, params: CosmologyParams, *, ng: int,
                      n_side: int, box_size: float, a_init,
                      use_2lpt: bool = True,
                      transfer: str = "eisenstein_hu",
                      h0_internal: float = 100.0,
                      kick_mode: str = "reference",
                      fixed_amplitude: bool = False, device=None):
    """(positions, velocities) for an n_side^3 lattice load from an ng^3
    Gaussian realization; `noise` is a PRNG key, a torch.Generator or a
    white-noise field (see `white_noise`)."""
    delta_k = gaussian_delta_k(noise, ng, box_size, params, transfer,
                               fixed_amplitude, device=device)
    dev = delta_k.device
    a_init = as_f32(a_init).to(dev)
    d1 = growth_factor(params, a_init)
    om_a = omega_m_a(params, a_init)

    psi1 = displacement_from_delta(delta_k, ng, box_size)
    psi1_l = _sample_field_at_lattice(psi1, n_side, ng) * d1

    q = lattice_positions(n_side, box_size, device=dev)
    disp = psi1_l
    vel_pref = ic_velocity_prefactor(params, a_init, h0_internal, kick_mode)
    f1 = growth_rate(params, a_init)
    vel = vel_pref * psi1_l

    if use_2lpt:
        d2 = -3.0 / 7.0 * om_a ** (-1.0 / 143.0) * d1 * d1
        f2 = 2.0 * om_a ** (6.0 / 11.0)
        psi2 = second_order_displacement(delta_k, ng, box_size)
        psi2_l = _sample_field_at_lattice(psi2, n_side, ng) * d2
        disp = disp + psi2_l
        vel = vel + (vel_pref / f1) * f2 * psi2_l

    pos = torch.remainder(q + disp, box_size)
    return pos, vel


def glass_relax(positions, box_size: float, iterations: int = 20,
                softening: float | None = None):
    """Relax a particle load towards a glass: `iterations` steps of
    *repulsive* unit-mass gravity, each moving every particle 0.05 of the
    mean separation times its acceleration over the largest acceleration
    component. Softening defaults to 0.05 of the lattice spacing. On the
    card the forces come from the K4 kernel; on the CPU from the
    row-blocked direct sum, as in the JAX package."""
    from ..forces.direct import direct_accelerations_chunked
    from ..ops.direct import pairwise_accelerations
    n = positions.shape[0]
    if softening is None:
        softening = 0.05 * box_size / max(round(n ** (1 / 3)), 1)
    step_scale = 0.05 * (box_size / max(n ** (1 / 3), 1.0))
    pos = positions
    ones = torch.ones((n,), dtype=pos.dtype, device=pos.device)
    for _ in range(iterations):
        if pos.device.type == "cuda":
            acc = pairwise_accelerations(pos, ones, box_size, softening, 1.0)
        else:
            acc = direct_accelerations_chunked(pos, ones, box_size,
                                               softening, 1.0)
        norm = torch.clamp(torch.max(torch.abs(acc)), min=1e-30)
        pos = torch.remainder(pos - step_scale * acc / norm, box_size)
    return pos


def glass_positions(key, n: int, box_size: float,
                    iterations: int = 20, softening: float | None = None,
                    device=None):
    """Glass-like load: n uniform random points relaxed by glass_relax.
    The points are prng.uniform(key, (n, 3), 0, box_size) on `device`
    (the card when none is named) when `key` is a PRNG key (the JAX
    package's draw), else drawn from `key` as a torch.Generator."""
    if prng.is_key(key):
        pos = prng.uniform(key, (n, 3), 0.0, box_size,
                           device="cuda" if device is None else device)
    else:
        pos = torch.rand((n, 3), generator=key, device=key.device,
                         dtype=torch.float32) * box_size
    return glass_relax(pos, box_size, iterations, softening)


def displacement_statistics(positions, box_size: float, n_side: int):
    """RMS, max and mean displacement from the n_side^3 lattice (minimum
    image), as 0-d tensors on the positions' device."""
    from ..forces.direct import min_image
    q = lattice_positions(n_side, box_size, device=positions.device)
    d = min_image(positions - q, box_size)
    mag = torch.sqrt(torch.sum(d * d, dim=-1))
    return {"rms_displacement": torch.sqrt(torch.mean(mag ** 2)),
            "max_displacement": torch.max(mag),
            "mean_displacement": torch.mean(mag)}


def generate_state(config, device="cuda") -> SimState:
    """Config-driven IC dispatch; returns a SimState at
    a_init = 1/(1+initial_redshift). The keys are the JAX package's:
    prng.PRNGKey(particles.initial_conditions.random_seed), split once,
    the second half feeding the LPT noise, the uniform load or the glass,
    so the state is the JAX package's realisation."""
    ic = config.particles.initial_conditions
    n = config.particles.num_particles
    box = config.particles.box_size
    a_init = 1.0 / (1.0 + config.cosmology.initial_redshift)
    params = config.cosmology_params()
    sub = prng.split(prng.PRNGKey(ic.random_seed))[1]

    if config.units.system == "box":
        mass = 1.0
    else:
        total = RHO_CRIT * float(params.omega_m) * box ** 3
        mass = total / n
    masses = torch.full((n,), mass, dtype=torch.float32, device=device)

    kind = ic.type.lower()
    if kind in ("zeldovich", "2lpt", "zel'dovich", "zeldovichgenerator"):
        n_side = round(n ** (1.0 / 3.0))
        if n_side ** 3 != n:
            raise ValueError(
                f"LPT ICs need a cubic particle number; got {n} "
                f"(nearest cube {n_side ** 3})")
        ng = max(ic.grid_size, n_side)
        if ng % n_side != 0:
            ng = n_side * max(1, round(ng / n_side))
        use_2lpt = ic.use_2lpt or kind == "2lpt"
        transfer = ic.power_spectrum or config.cosmology.transfer_function
        pos, vel = lpt_displacements(
            sub, params, ng=ng, n_side=n_side, box_size=box, a_init=a_init,
            use_2lpt=use_2lpt, transfer=transfer,
            h0_internal=config.units.H0_internal,
            kick_mode=config.integration.kick_mode, device=device)
        if not ic.velocity_perturbations:
            vel = torch.zeros_like(vel)
    elif kind in ("uniform_random", "random"):
        pos = prng.uniform(sub, (n, 3), 0.0, box, device=device)
        vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    elif kind == "grid":
        n_side = round(n ** (1.0 / 3.0))
        if n_side ** 3 != n:
            raise ValueError(f"grid ICs need a cubic N; got {n}")
        pos = lattice_positions(n_side, box, device=device)
        vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    elif kind == "glass":
        pos = glass_positions(sub, n, box, device=device)
        vel = torch.zeros((n, 3), dtype=torch.float32, device=device)
    else:
        raise ValueError(f"unknown IC generator {ic.type!r}")

    return make_state(pos, vel, masses, scale_factor=a_init,
                      time=config.time.initial_time, device=device)
