"""lambda_cdm_tpu_torch: the Lambda-CDM N-body framework of lambda_cdm_tpu
in PyTorch, with hand-written CUDA kernels for an NVIDIA Hopper GPU
(sm_90a, csrc/).

Its main path is treepm_fast: a persistent cell-bucketed stepper whose
force is a CIC deposit (K1), an FFT Poisson solve and an fd4 gather (K2)
plus short-range pairs (K3), with the KDK updates and the rebucket pass
on the card. Beside it: the config and the builder/engine with its
diagnostics, snapshots and checkpoints (npz, hdf5, the native .lcdm
codec); 2LPT and glass initial conditions drawn from the JAX package's
random streams; the stateless solvers (direct through K4/K4s, pm on its
own scatter and gather kernels, treepm) behind the force-computer
registry; the analysis (P(k), FoF with K5 and SO halos, merger trees);
the lensing raytracer with its sampler (K6/K7); the CLI, the science run
and the examples; and the multi-rank path on torch.distributed (parallel/:
the ring direct sum, the sharded PM and TreePM, migration, the slab and
pencil FFTs, and the slab, pencil and block fast steppers). The kernels'
plain PyTorch versions run for CPU tensors. This package never imports
JAX; the tests hold it against lambda_cdm_tpu.
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
