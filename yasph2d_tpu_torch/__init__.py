"""yasph2d_tpu_torch: the PyTorch + CUDA port of yasph2d_tpu for NVIDIA Hopper.

The package mirrors yasph2d_tpu's module paths. It imports torch and numpy and
never JAX. Its solvers so far:

- DFSPH, plane carry (models/dfsph_plane.DFSPHPlaneSolver);
- WCSPH, padded slot-major carry (models/wcsph_dense.WCSPHPaddedSolver);
- WCSPH, plane carry (models/wcsph_plane.WCSPHPlaneSolver).

They run on four hand-written CUDA kernels: K1, the pair reduction in plane
form (csrc/pair_reduce.cu, ops/pair_reduce.py; nine call forms), K2, the
re-bucket in plane form (csrc/rebucket.cu, ops/rebucket.py), K3, the pair
reduction in the slot-major layout (csrc/sm_pair_reduce.cu,
ops/sm_pair_reduce.py; three call forms) and K4, the re-bucket in that layout
(csrc/sm_rebucket.cu, ops/sm_rebucket.py). CUDA tensors run the kernels, CPU
tensors their plain PyTorch twins.
"""

from .models.dfsph_plane import DFSPHPlaneSolver
from .models.viscosity import PhysicalViscosityModel, XSPHViscosityModel
from .models.wcsph_dense import WCSPHPaddedSolver
from .models.wcsph_plane import WCSPHPlaneSolver
from .timemanager import AdaptiveTimeStep, FixedTimeStep
from .world import FluidParticleWorld

__all__ = [
    "AdaptiveTimeStep",
    "DFSPHPlaneSolver",
    "FixedTimeStep",
    "FluidParticleWorld",
    "PhysicalViscosityModel",
    "WCSPHPaddedSolver",
    "WCSPHPlaneSolver",
    "XSPHViscosityModel",
]
