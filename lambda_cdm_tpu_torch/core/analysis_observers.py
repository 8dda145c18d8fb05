"""Config-driven analysis observers (counterpart of
lambda_cdm_tpu/core/analysis_observers.py): snapshots, P(k), FoF + SO
halo catalogues, conservation diagnostics, particle statistics and Born
convergence maps, each at its cadence, with results pulled to the host
only when an observer fires. Their timers (`analysis.*`, `diagnostics.*`
in the engine's profiler) wait for the device, so they time finished work.

`build_observers_from_config` assembles the set from the io.snapshots /
io.analysis / io.diagnostics blocks (no config block asks for lensing: a
LensingObserver is added by hand, as in the JAX package).
"""

from __future__ import annotations

import math
import os

import torch

from .observers import Observer


def _host(x):
    return x.detach().cpu().numpy()


class SnapshotObserver(Observer):
    """Writes particle snapshots at io.snapshots.frequency."""

    def __init__(self, frequency: int, directory: str = "output",
                 pattern: str = "snapshot_{step:06d}_{redshift:.3f}.npz",
                 fields=None):
        self.frequency = max(1, frequency)
        self.directory = directory
        self.pattern = pattern
        self.fields = fields
        self.written: list[str] = []

    def on_step_end(self, engine, step):
        if step % self.frequency:
            return
        from ..utils import checkpoint as ckpt
        os.makedirs(self.directory, exist_ok=True)
        name = self.pattern.format(step=int(step),
                                   redshift=float(engine.state.redshift))
        path = ckpt.save_snapshot(os.path.join(self.directory, name),
                                  engine.state, engine.config,
                                  fields=self.fields)
        self.written.append(path)


class PowerSpectrumObserver(Observer):
    """Measures P(k) at its cadence; with `directory`, writes
    power_{step:06d}.txt there."""

    def __init__(self, frequency: int = 5, grid_size: int = 128,
                 num_bins: int = 64, assignment: str = "cic",
                 k_min=None, k_max=None, directory: str | None = None,
                 subtract_shot_noise: bool = True):
        self.frequency = max(1, frequency)
        self.grid_size = grid_size
        self.num_bins = num_bins
        self.assignment = assignment
        self.k_min, self.k_max = k_min, k_max
        self.directory = directory
        self.subtract_shot_noise = subtract_shot_noise
        self.results: list[dict] = []

    def on_step_end(self, engine, step):
        if step % self.frequency:
            return
        from ..analysis.power_spectrum import (measure_power_spectrum,
                                               save_power_spectrum)
        st = engine.state
        with engine.profiler.timer("analysis.power_spectrum",
                                   sync_on=st.positions):
            data = measure_power_spectrum(
                st.positions, engine.config.particles.box_size,
                ng=self.grid_size, num_bins=self.num_bins,
                assignment=self.assignment,
                subtract_shot_noise=self.subtract_shot_noise,
                k_min=self.k_min, k_max=self.k_max)
        self.results.append({
            "step": int(step), "scale_factor": float(st.scale_factor),
            "k": _host(data.k), "power": _host(data.power),
            "counts": _host(data.counts),
            "shot_noise": float(data.shot_noise)})
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
            save_power_spectrum(
                os.path.join(self.directory, f"power_{int(step):06d}.txt"),
                data)


class HaloFinderObserver(Observer):
    """FoF + SO halo catalogues at its cadence."""

    def __init__(self, frequency: int = 10, linking_length: float = 0.2,
                 min_particles: int = 20, max_halos: int | None = None,
                 overdensity: float = 200.0):
        self.frequency = max(1, frequency)
        self.linking_length = linking_length
        self.min_particles = min_particles
        self.max_halos = max_halos
        self.overdensity = overdensity
        self.catalogs: list[dict] = []

    def on_step_end(self, engine, step):
        if step % self.frequency:
            return
        from ..analysis.halo_finder import find_halos
        st = engine.state
        with engine.profiler.timer("analysis.halo_finder",
                                   sync_on=st.positions):
            cat = find_halos(
                st.positions, st.velocities, st.masses,
                engine.config.particles.box_size,
                linking_length_factor=self.linking_length,
                min_particles=self.min_particles,
                max_halos=self.max_halos, overdensity=self.overdensity,
                g_const=engine.config.units.G)
        nh = int(cat.num_halos)
        self.catalogs.append({
            "step": int(step), "num_halos": nh,
            "masses": _host(cat.mass)[:nh],
            "centers": _host(cat.center)[:nh],
            "radii": _host(cat.radius)[:nh],
            "spins": _host(cat.spin)[:nh],
        })


class ConservationObserver(Observer):
    """Energy / momentum / angular-momentum tracking (io.diagnostics).
    The energy is the O(N^2) pair sum of engine.compute_energy (K9 on the
    card) at every call."""

    def __init__(self, energy: bool = True, momentum: bool = True,
                 angular_momentum: bool = False, tolerance: float = 0.0):
        self.energy = energy
        self.momentum = momentum
        self.angular_momentum = angular_momentum
        self.tolerance = tolerance
        self.history: list[dict] = []
        self._e0 = None
        self.violations = 0

    def on_step_end(self, engine, step):
        rec = {"step": int(step)}
        pos = engine.state.positions
        if self.energy:
            with engine.profiler.timer("diagnostics.energy", sync_on=pos):
                e = engine.compute_energy()
            total = float(e["total"])
            if self._e0 is None:
                self._e0 = total
            err = abs(total - self._e0) / max(abs(self._e0), 1e-30)
            engine.last_energy_error = err
            rec.update(kinetic=float(e["kinetic"]),
                       potential=float(e["potential"]),
                       total=total, energy_error=err)
            if self.tolerance and err > self.tolerance:
                self.violations += 1
        if self.momentum:
            with engine.profiler.timer("diagnostics.momentum", sync_on=pos):
                rec["momentum"] = _host(engine.momentum())
        if self.angular_momentum:
            rec["angular_momentum"] = _host(engine.angular_momentum())
        self.history.append(rec)


class ParticleStatisticsObserver(Observer):
    """Per-chunk ensemble statistics: live count, rms and max speed, and
    the mean resultant length of the particles' unit-circle phases (1:
    concentrated, 0: uniform)."""

    def __init__(self):
        self.history: list[dict] = []

    @staticmethod
    def _stats(positions, velocities, masses, box):
        live = masses > 0
        n_live = torch.sum(live.to(torch.int32))
        w = torch.where(live, masses, 0.0)
        wsum = torch.clamp(torch.sum(w), min=1e-30)
        v2 = torch.sum(velocities * velocities, dim=-1)
        v_rms = torch.sqrt(torch.sum(w * v2) / wsum)
        v_max = torch.sqrt(torch.max(torch.where(live, v2, 0.0)))
        theta = positions / box * (2.0 * math.pi)
        cx = torch.sum(w[:, None] * torch.cos(theta), dim=0) / wsum
        sx = torch.sum(w[:, None] * torch.sin(theta), dim=0) / wsum
        clustering = torch.mean(torch.sqrt(cx * cx + sx * sx))
        return n_live, v_rms, v_max, clustering

    def on_step_end(self, engine, step):
        st = engine.state
        with engine.profiler.timer("diagnostics.particle_statistics",
                                   sync_on=st.positions):
            n_live, v_rms, v_max, clustering = self._stats(
                st.positions, st.velocities, st.masses,
                engine.config.particles.box_size)
        self.history.append({
            "step": int(step),
            "scale_factor": float(st.scale_factor),
            "n_live": int(n_live),
            "v_rms": float(v_rms),
            "v_max": float(v_max),
            "clustering_rbar": float(clustering),
        })


class LensingObserver(Observer):
    """Born convergence maps at its cadence (kappa and its population rms).
    With `render_dir` set, each map is also rendered to a PNG there (None
    in the record where matplotlib is missing)."""

    def __init__(self, frequency: int = 50, grid_size: int = 128,
                 n_planes: int = 8, z_source: float = 1.0,
                 render_dir: str = ""):
        self.frequency = max(1, frequency)
        self.grid_size = grid_size
        self.n_planes = n_planes
        self.z_source = z_source
        self.render_dir = render_dir
        self.maps: list[dict] = []

    def on_step_end(self, engine, step):
        if step % self.frequency:
            return
        from ..raytracing.lensing import convergence_map_from_state
        st = engine.state
        with engine.profiler.timer("analysis.lensing",
                                   sync_on=st.positions):
            kap = convergence_map_from_state(
                st, engine.config.cosmology_params(),
                engine.config.particles.box_size,
                ng=self.grid_size, n_planes=self.n_planes,
                z_source=self.z_source)
        rec = {"step": int(step), "kappa": _host(kap),
               "kappa_rms": float(torch.std(kap, correction=0))}
        if self.render_dir:
            rec["png"] = self._render(rec["kappa"], int(step),
                                      float(st.redshift))
        self.maps.append(rec)

    def _render(self, kappa, step, redshift) -> str | None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return None
        import numpy as np
        os.makedirs(self.render_dir, exist_ok=True)
        path = os.path.join(self.render_dir,
                            f"kappa_{step:06d}_z{redshift:.2f}.png")
        fig, ax = plt.subplots(figsize=(5, 4), dpi=120)
        vmax = float(np.percentile(np.abs(kappa), 99.5)) or 1e-9
        im = ax.imshow(kappa, origin="lower", cmap="inferno",
                       vmin=-vmax, vmax=vmax)
        ax.set_title(f"Born convergence  step {step}  z={redshift:.2f}")
        ax.set_xlabel("x [pix]")
        ax.set_ylabel("y [pix]")
        fig.colorbar(im, ax=ax, label=r"$\kappa$")
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
        return path


def build_observers_from_config(config) -> list[Observer]:
    """The observer set the config's io.* blocks ask for."""
    obs: list[Observer] = []
    io = config.io
    if io.snapshots.enabled:
        obs.append(SnapshotObserver(
            frequency=io.snapshots.frequency,
            directory=config.simulation.output_directory,
            pattern=io.snapshots.filename_pattern,
            fields=io.snapshots.fields))
    if io.analysis.enabled and io.analysis.power_spectrum.enabled:
        ps = io.analysis.power_spectrum
        grid = ps.grid_size or config.particles.initial_conditions.grid_size
        obs.append(PowerSpectrumObserver(
            frequency=ps.frequency, grid_size=max(grid, 32),
            num_bins=ps.num_bins, assignment=ps.assignment,
            k_min=ps.k_min, k_max=ps.k_max,
            directory=config.simulation.output_directory))
    if io.analysis.enabled and io.analysis.halo_finder.enabled:
        hfc = io.analysis.halo_finder
        obs.append(HaloFinderObserver(
            frequency=hfc.frequency,
            linking_length=hfc.linking_length,
            min_particles=hfc.min_particles,
            overdensity=hfc.overdensity))
    d = io.diagnostics
    if d.energy_conservation or d.momentum_conservation \
            or d.angular_momentum_conservation:
        obs.append(ConservationObserver(
            energy=d.energy_conservation,
            momentum=d.momentum_conservation,
            angular_momentum=d.angular_momentum_conservation,
            tolerance=config.validation.tolerance
            if config.validation.check_energy_conservation else 0.0))
    if d.particle_statistics:
        obs.append(ParticleStatisticsObserver())
    return obs
