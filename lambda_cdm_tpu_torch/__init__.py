"""lambda_cdm_tpu_torch: the Lambda-CDM N-body framework of lambda_cdm_tpu
ported to PyTorch, with hand-written CUDA kernels for an NVIDIA Hopper
GPU (sm_90a).

Ported so far: the single-device treepm_fast path -- config, 2LPT
initial conditions, the cell-bucketed stepper with its three kernels
(K1 CIC deposit, K2 fused CIC x fd4 gather, K3 short-range pairs), the
engine/builder with its diagnostics, snapshots and checkpoints -- the
CLI run with its analysis: P(k), the FoF + SO halo finder with its
kernel (K5 FoF hook sweep) and the config-driven observers -- and the
stateless solvers (direct with its kernels K4/K4s, pm, treepm) behind the
force-computer registry, with the engine's fused KDK loop, the
force-accuracy harness, EnergyMonitor and glass initial conditions --
and the lensing raytracer: lens planes, Born maps, multi-plane ray tracing
with Jacobians through its sampler kernel (K6/K7), the angular spectra
and LensingObserver -- and the JAX package's random streams
(utils/prng: jax.random's Threefry keys, uniforms and normals, so a
config gives the JAX package's particles), the float64 Ewald oracle,
merger trees, the torch.profiler trace, the engine's warmup and
CompiledForceEngine. The kernels' plain PyTorch versions run for CPU
tensors. This package never imports JAX; the tests hold it against
lambda_cdm_tpu.
"""

__version__ = "0.1.0"

from .analysis.halo_finder import HaloCatalog, find_halos
from .analysis.power_spectrum import (PowerSpectrumData,
                                      measure_power_spectrum)
from .core.analysis_observers import (ConservationObserver,
                                      HaloFinderObserver, LensingObserver,
                                      ParticleStatisticsObserver,
                                      PowerSpectrumObserver,
                                      SnapshotObserver,
                                      build_observers_from_config)
from .core.config import SimulationConfig
from .core.engine import (LifecycleState, SimulationBuilder,
                          SimulationEngine, SimulationStatistics)
from .core.observers import (EnergyMonitor, MetricsRecorder, Observer,
                             ProgressObserver)
from .core.state import SimState, make_state, random_state
from .physics.cosmology import PLANCK, CosmologyParams

__all__ = [
    "__version__",
    "SimulationConfig", "SimulationBuilder", "SimulationEngine",
    "SimulationStatistics", "LifecycleState",
    "Observer", "ProgressObserver", "EnergyMonitor", "MetricsRecorder",
    "SnapshotObserver", "PowerSpectrumObserver", "HaloFinderObserver",
    "ConservationObserver", "ParticleStatisticsObserver", "LensingObserver",
    "build_observers_from_config",
    "SimState", "make_state", "random_state",
    "CosmologyParams", "PLANCK",
    "HaloCatalog", "find_halos", "PowerSpectrumData",
    "measure_power_spectrum",
]
