"""lambda_cdm_tpu_torch: the Lambda-CDM N-body framework of lambda_cdm_tpu
ported to PyTorch, with hand-written CUDA kernels for an NVIDIA Hopper
GPU (sm_90a).

Ported so far: the single-device treepm_fast path -- config, 2LPT
initial conditions, the cell-bucketed stepper with its three kernels
(K1 CIC deposit, K2 fused CIC x fd4 gather, K3 short-range pairs; their
plain PyTorch versions run for CPU tensors), and the engine/builder.
This package never imports JAX; the tests hold it against lambda_cdm_tpu.
"""

__version__ = "0.1.0"

from .core.config import SimulationConfig
from .core.engine import (LifecycleState, SimulationBuilder,
                          SimulationEngine, SimulationStatistics)
from .core.observers import MetricsRecorder, Observer, ProgressObserver
from .core.state import SimState, make_state
from .physics.cosmology import PLANCK, CosmologyParams

__all__ = [
    "__version__",
    "SimulationConfig", "SimulationBuilder", "SimulationEngine",
    "SimulationStatistics", "LifecycleState",
    "Observer", "ProgressObserver", "MetricsRecorder",
    "SimState", "make_state",
    "CosmologyParams", "PLANCK",
]
