"""yasph2d_tpu_torch: the PyTorch + CUDA port of yasph2d_tpu for NVIDIA Hopper.

The package mirrors yasph2d_tpu's module paths. It imports torch and numpy and
never JAX. Its slice so far is the DFSPH plane step
(models/dfsph_plane.DFSPHPlaneSolver) with its two CUDA kernels: the pair
reduction (csrc/pair_reduce.cu, ops/pair_reduce.py) and the re-bucket
(csrc/rebucket.cu, ops/rebucket.py). CUDA tensors run the kernels, CPU tensors
their plain PyTorch twins.
"""

from .models.dfsph_plane import DFSPHPlaneSolver
from .models.viscosity import PhysicalViscosityModel, XSPHViscosityModel
from .timemanager import AdaptiveTimeStep, FixedTimeStep
from .world import FluidParticleWorld

__all__ = [
    "AdaptiveTimeStep",
    "DFSPHPlaneSolver",
    "FixedTimeStep",
    "FluidParticleWorld",
    "PhysicalViscosityModel",
    "XSPHViscosityModel",
]
