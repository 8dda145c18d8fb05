"""Typed, hierarchical configuration system.

The reference promises a hierarchical JSON/YAML config manager with typed
path access, environment and CLI overrides, and schema validation
(include/core/configuration_manager.hpp:12-175) -- but its loader is a stub
that ignores the file and installs hard-coded defaults
(src/core/configuration_manager.cpp:13-62). This module implements the
promised capability for real:

  * dataclass schema matching examples/configs/basic_lambda_cdm.json:1-183,
  * `SimulationConfig.from_file` / `from_dict` that genuinely parse JSON,
  * dotted-path get/set (`cfg.get("physics.cosmology.parameters.omega_m")`),
  * environment-variable overrides (LCDM_physics__cosmology__...=value),
  * CLI overrides (--physics.integration...=value),
  * validation with helpful errors.

TPU adaptations: the `compute.gpu`/`compute.tensorrt` blocks of the
reference map onto `compute.tpu` (precision, per-device particle capacity)
and `compute.mesh` (device mesh axes replacing `compute.mpi`). The original
key names are still accepted and translated so reference config files load
unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(v) for v in obj]
    return obj


def _build(cls, data: dict):
    """Construct dataclass `cls` from a dict, recursing into nested
    dataclass fields and ignoring unknown keys (forward compat)."""
    if data is None:
        return cls()
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        ftype = f.type if not isinstance(f.type, str) else None
        target = _DATACLASS_FIELDS.get((cls, f.name))
        if target is not None and isinstance(val, dict):
            kwargs[f.name] = _build(target, val)
        else:
            kwargs[f.name] = val
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Schema (mirrors examples/configs/basic_lambda_cdm.json)
# ---------------------------------------------------------------------------

@dataclass
class CosmologyConfig:
    model: str = "LambdaCDMModel"
    omega_m: float = 0.31
    omega_lambda: float = 0.69
    omega_b: float = 0.049
    omega_k: float = 0.0
    omega_r: float = 0.0
    h: float = 0.67
    sigma_8: float = 0.81
    n_s: float = 0.965
    w0: float = -1.0
    wa: float = 0.0
    transfer_function: str = "eisenstein_hu"  # bbks | eisenstein_hu | eh98_nowiggle
    initial_redshift: float = 49.0
    final_redshift: float = 0.0


@dataclass
class ForceConfig:
    # type mirrors ForceComputerFactory names (force_computer_factory.hpp:20-27):
    # direct | pm | treepm | treepm_fast | pm_fast | direct_reference
    type: str = "direct"
    name: str = "MainForceComputer"
    softening_length: float = 0.01
    opening_angle: float = 0.5          # accepted for config compat (tree)
    pm_grid_size: int = 0               # 0 -> auto (cbrt(N*2) heuristic)
    split_factor: float = 1.25          # treepm rs in PM cells
    cut_factor: float = 4.5             # treepm r_cut in units of rs
    bucket_capacity: int = 0            # 0 -> auto (4x mean occupancy)
    rebucket_every: int = 16            # treepm_fast cell-list refresh
    gradient: str = "fd4"               # fast-path PM gradient:
    #                                     fd4 | spectral | interp
    force_kernel: str = "newtonian"     # newtonian | modified_gravity
    modified_gravity_strength: float = 0.0
    # float32 -> Precision.HIGHEST contractions (default); bfloat16 ->
    # bf16 MXU operands / f32 accumulate in the jnp direct solvers
    # (~0.4% force error; the reference TRT FP16 flag analogue). The
    # Pallas kernels are f32 throughout either way.
    precision: str = "float32"
    fallback: str = "direct_reference"


@dataclass
class IntegrationConfig:
    type: str = "LeapfrogIntegrator"     # KDK
    adaptive_timestep: bool = False
    min_timestep: float = 1e-6
    max_timestep: float = 0.1
    accuracy_tolerance: float = 1e-8
    max_dloga: float = 0.0               # adaptive: dt <= max_dloga / H(a)
    scale_factor_update: str = "rk4"     # euler (reference parity) | rk4
    # comoving: canonical-momentum KDK (kick 1/a, drift 1/a^2) -- true
    #   comoving dynamics; reproduces linear-theory growth to <10%
    #   (tests/test_linear_growth.py).
    # reference: the reference's 1/a^2 kick with unit drift and NO
    #   Hubble drag (lambda_cdm_kernels.cu:310-335) -- kept for parity;
    #   over-grows structure ~12% per a-octave (characterization test).
    # Default fixed to the correct physics, like scale_factor_update
    # rk4-vs-euler (SURVEY.md section 2.4 fidelity stance).
    kick_mode: str = "comoving"          # comoving | reference | newtonian


@dataclass
class InitialConditionsConfig:
    type: str = "ZelDovichGenerator"     # zeldovich | 2lpt | uniform_random | glass | grid
    # "" inherits cosmology.transfer_function; an explicit value here
    # overrides it for the IC realization only
    power_spectrum: str = ""
    random_seed: int = 12345
    grid_size: int = 64
    use_2lpt: bool = True
    velocity_perturbations: bool = True


@dataclass
class ParticlesConfig:
    num_particles: int = 10000
    box_size: float = 100.0              # Mpc/h
    periodic_boundaries: bool = True
    initial_conditions: InitialConditionsConfig = field(
        default_factory=InitialConditionsConfig)


@dataclass
class TPUConfig:
    enabled: bool = True
    precision: str = "float32"           # float32 | bfloat16 (pairwise math)
    max_particles: int = 16_000_000      # capacity profile (cf. TRT max profile)
    donate_state: bool = True
    # persistent XLA compilation cache (the TRT engine-file analogue):
    # set to a directory to make repeated engine starts at the same
    # shapes compile in seconds instead of minutes
    compilation_cache_dir: str = ""
    persistent_cache_min_compile_secs: float = 5.0


@dataclass
class MeshConfig:
    """Device-mesh / sharding config (replaces compute.mpi:
    README.md MPI block + cluster_comm.cpp 3D cartesian decomposition).

    axes: {"shard": -1} (default) = 1D slab decomposition over all
    devices; {"shx": DX, "shy": DY} = 2D (cx, cy)-rod pencil
    decomposition (parallel/fast_mesh2d) for treepm_fast."""
    enabled: bool = False
    axes: dict = field(default_factory=lambda: {"shard": -1})  # -1: all devices
    # halo/ghost bucket headroom for the stateless sharded TreePM:
    # cell capacity = factor x mean occupancy (the ghost-exchange
    # buffers of cluster_comm.cpp:166-206, sized instead of dynamic)
    ghost_capacity_factor: float = 3.0
    migrate_capacity_factor: float = 1.5  # padded migration-bucket headroom
    migrate_fraction: float = 0.125      # emigrant-bucket capacity / n_loc
    load_balancing: bool = True
    rebalance_threshold: float = 0.2     # cluster_comm.cpp:314-349 trigger
    # what the adaptive partition equalizes: "count" = live particles;
    # "pair_cost" = per-cell occupancy^2 (the pairwise kernel's true
    # work -- the reference balances measured per-rank compute time,
    # cluster_comm.cpp:314-349; occupancy^2 is its density proxy)
    balance_weight: str = "count"


@dataclass
class ComputeConfig:
    tpu: TPUConfig = field(default_factory=TPUConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


@dataclass
class TimeConfig:
    initial_time: float = 0.0
    final_time: float = 10.0
    initial_timestep: float = 0.01
    max_steps: int = 1_000_000
    time_units: str = "internal"         # internal: (Mpc/h)/(km/s)


@dataclass
class PowerSpectrumAnalysisConfig:
    enabled: bool = True
    frequency: int = 5
    k_min: float = 0.01
    k_max: float = 10.0
    num_bins: int = 100
    grid_size: int = 0                   # 0 -> use IC grid size
    assignment: str = "cic"              # cic | ngp | tsc


@dataclass
class HaloFinderAnalysisConfig:
    enabled: bool = False
    frequency: int = 10
    algorithm: str = "FoF"
    linking_length: float = 0.2
    min_particles: int = 20
    overdensity: float = 200.0


@dataclass
class AnalysisConfig:
    enabled: bool = True
    power_spectrum: PowerSpectrumAnalysisConfig = field(
        default_factory=PowerSpectrumAnalysisConfig)
    halo_finder: HaloFinderAnalysisConfig = field(
        default_factory=HaloFinderAnalysisConfig)


@dataclass
class SnapshotsConfig:
    enabled: bool = True
    frequency: int = 10
    filename_pattern: str = "snapshot_{step:06d}_{redshift:.3f}.npz"
    fields: list = field(default_factory=lambda: [
        "positions", "velocities", "masses", "particle_ids"])


@dataclass
class DiagnosticsConfig:
    energy_conservation: bool = True
    momentum_conservation: bool = True
    angular_momentum_conservation: bool = False
    particle_statistics: bool = True


@dataclass
class IOConfig:
    output_format: str = "npz"           # npz | orbax | hdf5 | lcdm | ascii
    snapshots: SnapshotsConfig = field(default_factory=SnapshotsConfig)
    analysis: AnalysisConfig = field(default_factory=AnalysisConfig)
    diagnostics: DiagnosticsConfig = field(default_factory=DiagnosticsConfig)


@dataclass
class LoggingConfig:
    """Configures the package logger ("lambda_cdm_tpu") via
    `configure_logging` (called from SimulationEngine.__init__).
    performance_logging additionally emits a per-chunk throughput INFO
    line from the run loop."""
    level: str = "INFO"
    console_output: bool = True
    file_output: bool = False
    log_file: str = "simulation.log"
    performance_logging: bool = True


@dataclass
class ProfilingConfig:
    enabled: bool = True
    detailed_timing: bool = True
    output_file: str = "profiling_report.json"
    # non-empty: capture a jax.profiler device trace of the run loop
    # into this directory (TensorBoard-viewable; the working analogue of
    # the reference's unused cuda_profiler_api include)
    trace_dir: str = ""


@dataclass
class ValidationConfig:
    check_initial_conditions: bool = True
    # solver-vs-direct-summation accuracy harness at initialize()
    # (engine.validate_force_accuracy; the reference's barnes_hut_test
    # tree-vs-direct error report, examples/barnes_hut_test.cu:191-250)
    validate_forces: bool = False
    force_tolerance: float = 0.05       # warn above this avg rel. error
    force_samples: int = 1024           # oracle targets (O(samples * N))
    check_energy_conservation: bool = True
    # per-chunk non-finite state guard in run() (failure detection;
    # costs one scalar readback per chunk -- the chunk boundary already
    # syncs, so this is ~free)
    check_finite: bool = False
    tolerance: float = 1e-6


@dataclass
class SimulationMetaConfig:
    name: str = "LambdaCDM"
    description: str = ""
    version: str = "1.0.0"
    output_directory: str = "output"
    checkpoint_frequency: int = 100
    output_frequency: int = 10


@dataclass
class UnitsConfig:
    """Internal unit system. Default 'gadget-like': length Mpc/h,
    velocity km/s, mass 1e10 Msun/h -> G = 43.0071, H0 = 100 (internal).
    'box' mode (reference parity, lambda_cdm_kernels.cu G=1) sets G=1 and
    takes H0_internal from config."""
    system: str = "cosmological"         # cosmological | box
    G: float = 43.0071057317063
    H0_internal: float = 100.0


@dataclass
class SimulationConfig:
    simulation: SimulationMetaConfig = field(
        default_factory=SimulationMetaConfig)
    cosmology: CosmologyConfig = field(default_factory=CosmologyConfig)
    forces: ForceConfig = field(default_factory=ForceConfig)
    integration: IntegrationConfig = field(default_factory=IntegrationConfig)
    particles: ParticlesConfig = field(default_factory=ParticlesConfig)
    compute: ComputeConfig = field(default_factory=ComputeConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    io: IOConfig = field(default_factory=IOConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    profiling: ProfilingConfig = field(default_factory=ProfilingConfig)
    validation: ValidationConfig = field(default_factory=ValidationConfig)
    units: UnitsConfig = field(default_factory=UnitsConfig)

    # -- path access (the API ConfigurationManager promised,
    #    configuration_manager.hpp:152-164, but implemented flat) ----------
    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if dataclasses.is_dataclass(node):
                if not hasattr(node, part):
                    return default
                node = getattr(node, part)
            elif isinstance(node, dict):
                if part not in node:
                    return default
                node = node[part]
            else:
                return default
        return node

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            node = getattr(node, part) if dataclasses.is_dataclass(node) \
                else node[part]
        leaf = parts[-1]
        if dataclasses.is_dataclass(node):
            current = getattr(node, leaf, None)
            if current is not None and not isinstance(value, type(current)):
                value = _coerce(value, type(current))
            object.__setattr__(node, leaf, value)
        else:
            node[leaf] = value

    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    # -- loaders ----------------------------------------------------------
    @classmethod
    def from_dict(cls, data: dict) -> "SimulationConfig":
        data = _translate_reference_schema(dict(data))
        return _build(cls, data)

    @classmethod
    def from_file(cls, path: str) -> "SimulationConfig":
        """Load JSON / YAML / TOML by extension (the hierarchical
        multi-format loader ConfigurationManager only promised,
        configuration_manager.hpp:58-131 / .cpp:13-23 stub)."""
        low = path.lower()
        if low.endswith((".yaml", ".yml")):
            import yaml
            with open(path) as f:
                return cls.from_dict(yaml.safe_load(f) or {})
        if low.endswith(".toml"):
            import tomllib
            with open(path, "rb") as f:
                return cls.from_dict(tomllib.load(f))
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # -- overrides --------------------------------------------------------
    def apply_env_overrides(self, environ=None, prefix="LCDM_") -> None:
        """LCDM_physics__cosmology__h=0.7 -> set('cosmology.h', 0.7)
        (the capability of ConfigurationManager::apply_environment_overrides,
        configuration_manager.hpp:101-104)."""
        environ = os.environ if environ is None else environ
        for key, val in environ.items():
            if not key.startswith(prefix):
                continue
            path = key[len(prefix):].replace("__", ".")
            try:
                self.set(path, _parse_value(val))
            except (AttributeError, KeyError, TypeError):
                pass

    def apply_cli_overrides(self, argv) -> list:
        """--a.b.c=value overrides; returns unconsumed args
        (ConfigurationManager::apply_command_line_overrides,
        configuration_manager.hpp:105)."""
        rest = []
        for arg in argv:
            if arg.startswith("--") and "=" in arg:
                path, _, val = arg[2:].partition("=")
                try:
                    self.set(path, _parse_value(val))
                    continue
                except (AttributeError, KeyError, TypeError):
                    pass
            rest.append(arg)
        return rest

    # -- validation -------------------------------------------------------
    def validate(self) -> None:
        c = self.cosmology
        total = c.omega_m + c.omega_lambda + c.omega_k + c.omega_r
        if abs(total - 1.0) > 1e-3:
            raise ValueError(f"Omega budget != 1 (got {total})")
        if self.particles.num_particles <= 0:
            raise ValueError("particles.num_particles must be > 0")
        if self.particles.box_size <= 0:
            raise ValueError("particles.box_size must be > 0")
        if self.time.initial_timestep <= 0:
            raise ValueError("time.initial_timestep must be > 0")
        if self.forces.type not in (
                "direct", "direct_reference", "pm", "treepm",
                "treepm_fast", "pm_fast"):
            raise ValueError(f"unknown forces.type '{self.forces.type}'")
        if self.forces.softening_length < 0:
            raise ValueError("softening_length must be >= 0")
        if self.particles.num_particles > self.compute.tpu.max_particles:
            raise ValueError(
                f"particles.num_particles={self.particles.num_particles} "
                f"exceeds compute.tpu.max_particles="
                f"{self.compute.tpu.max_particles} (the per-device "
                f"capacity ceiling; raise it, or enable compute.mesh to "
                f"shard the box)")
        if self.compute.mesh.balance_weight not in ("count", "pair_cost"):
            raise ValueError(
                f"compute.mesh.balance_weight "
                f"'{self.compute.mesh.balance_weight}' (choose 'count' "
                f"or 'pair_cost')")
        if self.time.time_units not in ("internal", "gyr"):
            raise ValueError(
                f"time.time_units '{self.time.time_units}' (choose "
                f"'internal' = (Mpc/h)/(km/s), or 'gyr' for converted "
                f"statistics/current-time reporting)")
        # loud no-op warnings: a knob that silently does nothing is
        # worse than no knob (the reference's central disease,
        # configuration_manager.cpp:13-62)
        import logging
        logger = logging.getLogger("lambda_cdm_tpu")
        if self.forces.opening_angle != 0.5:
            logger.warning(
                "forces.opening_angle=%g has no effect: the PM-split "
                "solvers have no Barnes-Hut opening criterion -- "
                "short-range accuracy is set by forces.split_factor "
                "(rs) and forces.cut_factor (r_cut/rs)",
                self.forces.opening_angle)
        if self.integration.accuracy_tolerance != 1e-8:
            logger.warning(
                "integration.accuracy_tolerance=%g has no effect: the "
                "KDK integrator is fixed-order -- timestep accuracy is "
                "set by integration.adaptive_timestep (acceleration "
                "limiter) and integration.max_dloga (expansion limiter)",
                self.integration.accuracy_tolerance)

    def cosmology_params(self):
        from ..physics.cosmology import CosmologyParams
        c = self.cosmology
        return CosmologyParams(
            omega_m=c.omega_m, omega_lambda=c.omega_lambda,
            omega_b=c.omega_b, omega_k=c.omega_k, omega_r=c.omega_r,
            h=c.h, sigma8=c.sigma_8, n_s=c.n_s, w0=c.w0, wa=c.wa)


# nested dataclass wiring for _build
_DATACLASS_FIELDS = {}
_DATACLASS_FIELDS.update({
    (SimulationConfig, "simulation"): SimulationMetaConfig,
    (SimulationConfig, "cosmology"): CosmologyConfig,
    (SimulationConfig, "forces"): ForceConfig,
    (SimulationConfig, "integration"): IntegrationConfig,
    (SimulationConfig, "particles"): ParticlesConfig,
    (SimulationConfig, "compute"): ComputeConfig,
    (SimulationConfig, "time"): TimeConfig,
    (SimulationConfig, "io"): IOConfig,
    (SimulationConfig, "logging"): LoggingConfig,
    (SimulationConfig, "profiling"): ProfilingConfig,
    (SimulationConfig, "validation"): ValidationConfig,
    (SimulationConfig, "units"): UnitsConfig,
    (ParticlesConfig, "initial_conditions"): InitialConditionsConfig,
    (ComputeConfig, "tpu"): TPUConfig,
    (ComputeConfig, "mesh"): MeshConfig,
    (IOConfig, "snapshots"): SnapshotsConfig,
    (IOConfig, "analysis"): AnalysisConfig,
    (IOConfig, "diagnostics"): DiagnosticsConfig,
    (AnalysisConfig, "power_spectrum"): PowerSpectrumAnalysisConfig,
    (AnalysisConfig, "halo_finder"): HaloFinderAnalysisConfig,
})


def configure_logging(cfg: "SimulationConfig") -> None:
    """Apply the `logging` config block to the package logger (the
    reference parses an identical block,
    examples/configs/basic_lambda_cdm.json:160-166, and never reads it;
    src/core/configuration_manager.cpp:13-62 installs hard-coded
    defaults). Idempotent: handlers installed here are tagged and
    replaced, never duplicated, so user-installed handlers survive."""
    import logging
    lc = cfg.logging
    logger = logging.getLogger("lambda_cdm_tpu")
    level = getattr(logging, str(lc.level).upper(), None)
    if not isinstance(level, int):
        raise ValueError(f"logging.level '{lc.level}' is not a python "
                         f"logging level (DEBUG/INFO/WARNING/ERROR)")
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s")
    for h in list(logger.handlers):
        if getattr(h, "_lcdm_config_handler", False):
            logger.removeHandler(h)
            h.close()
    if lc.console_output:
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        h._lcdm_config_handler = True
        logger.addHandler(h)
    if lc.file_output and lc.log_file:
        h = logging.FileHandler(lc.log_file)
        h.setFormatter(fmt)
        h._lcdm_config_handler = True
        logger.addHandler(h)


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except (json.JSONDecodeError, ValueError):
        return s


def _coerce(value: Any, target: type) -> Any:
    if target is bool and isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    try:
        return target(value)
    except (TypeError, ValueError):
        return value


def _translate_reference_schema(data: dict) -> dict:
    """Accept reference-layout JSON (examples/configs/basic_lambda_cdm.json)
    and map it onto our flatter schema. Our native layout passes through."""
    out = dict(data)

    phys = data.get("physics", {})
    if phys:
        cosmo = phys.get("cosmology", {})
        c = dict(cosmo.get("parameters", {}))
        for k in ("initial_redshift", "final_redshift", "model"):
            if k in cosmo:
                c[k] = cosmo[k]
        out.setdefault("cosmology", {}).update(
            {k: v for k, v in c.items() if k != "sigma_8"} |
            ({"sigma_8": c["sigma_8"]} if "sigma_8" in c else {}))

        forces = phys.get("forces", {})
        primary = forces.get("primary_computer", {})
        if primary:
            f = dict(primary.get("parameters", {}))
            type_map = {
                "TreeForceComputer": "treepm",
                "DirectForceComputer": "direct",
                "PMForceComputer": "pm",
                "TensorRTForceComputer": "direct",  # compiled direct path
            }
            f["type"] = type_map.get(primary.get("type", ""), "direct")
            f["name"] = primary.get("name", "MainForceComputer")
            fb = forces.get("fallback_computers") or []
            if fb:
                f["fallback"] = type_map.get(fb[0].get("type", ""),
                                             "direct_reference")
            keep = {k: v for k, v in f.items()
                    if k in {fl.name for fl in dataclasses.fields(ForceConfig)}}
            out.setdefault("forces", {}).update(keep)

        integ = phys.get("integration", {}).get("integrator", {})
        if integ:
            i = dict(integ.get("parameters", {}))
            i["type"] = integ.get("type", "LeapfrogIntegrator")
            keep = {k: v for k, v in i.items()
                    if k in {fl.name
                             for fl in dataclasses.fields(IntegrationConfig)}}
            out.setdefault("integration", {}).update(keep)

    parts = data.get("particles", {})
    if parts:
        p = {k: v for k, v in parts.items() if k != "initial_conditions"}
        ic_gen = parts.get("initial_conditions", {}).get("generator", {})
        if ic_gen:
            ic = dict(ic_gen.get("parameters", {}))
            gen_map = {"ZelDovichGenerator": "zeldovich",
                       "2LPTGenerator": "2lpt",
                       "GlassGenerator": "glass",
                       "RandomGenerator": "uniform_random",
                       "GridGenerator": "grid"}
            ic["type"] = gen_map.get(ic_gen.get("type", ""), "zeldovich")
            if ic.get("power_spectrum") in ("CDM", "cdm"):
                ic["power_spectrum"] = "eisenstein_hu"
            p["initial_conditions"] = ic
        out["particles"] = p

    comp = data.get("compute", {})
    if comp and ("gpu" in comp or "tensorrt" in comp or "mpi" in comp):
        tpu = {}
        gpu = comp.get("gpu", {})
        trt = comp.get("tensorrt", {})
        if "enabled" in gpu:
            tpu["enabled"] = gpu["enabled"]
        if trt.get("precision", "").upper() in ("FP16", "BF16"):
            tpu["precision"] = "bfloat16"
        if "max_batch_size" in trt:
            tpu["max_particles"] = trt["max_batch_size"]
        mesh = {}
        mpi = comp.get("mpi", {})
        if "enabled" in mpi:
            mesh["enabled"] = mpi["enabled"]
        if "load_balancing" in mpi:
            mesh["load_balancing"] = mpi["load_balancing"]
        out["compute"] = {"tpu": tpu, "mesh": mesh}

    io = data.get("io", {})
    if io:
        io = dict(io)
        io.pop("compression", None)
        io.pop("compression_level", None)
        fmt = io.get("output_format", "")
        if fmt.upper() == "HDF5":
            io["output_format"] = "hdf5"     # real h5py writer
        out["io"] = io

    out.pop("physics", None)
    return out
