"""yasph2d_tpu_torch: the PyTorch + CUDA port of yasph2d_tpu for NVIDIA Hopper.

The package mirrors yasph2d_tpu's module paths. It imports torch and numpy and
never JAX. Its solvers so far:

- DFSPH, padded slot-major carry (models/dfsph_dense.DFSPHPaddedSolver);
- DFSPH, plane carry (models/dfsph_plane.DFSPHPlaneSolver);
- WCSPH, padded slot-major carry (models/wcsph_dense.WCSPHPaddedSolver);
- WCSPH, plane carry (models/wcsph_plane.WCSPHPlaneSolver).

They run on five hand-written CUDA kernels: K1, the pair reduction in plane
form (csrc/pair_reduce.cu, ops/pair_reduce.py), K2, the re-bucket in plane
form (csrc/rebucket.cu, ops/rebucket.py), K3, the pair reduction in the
slot-major layout in the TPU kernel's per-candidate order (ops/sm_pair_reduce.py),
K4, the re-bucket in that layout (csrc/sm_rebucket.cu, ops/sm_rebucket.py),
and K5, the pair reduction in that layout with per-view sums
(ops/pallas_pair.py); K3 and K5 are one kernel on shared-memory cell tiles
(csrc/tile_pair_reduce.cu) with the sum order as a template parameter. The padded solvers run their
pair passes on K3 when `DenseGridConfig.use_pallas_slotmajor` is True and on
K5 when it is False (the default); the plane solvers require True. CUDA
tensors run the kernels, CPU tensors their plain PyTorch twins. The scene's
tensors (`FluidParticleWorld.initial_state`, `boundary_dense`) are made on the
card unless `device="cpu"` is asked for. Both viscosity models of the JAX
package run on every kernel that sums viscosity (the `*_phys` call forms for
PhysicalViscosityModel).

The configured entry point is the JAX package's: a `SimulationConfig` JSON
(config.py, the same schema), built by `cfg.build(device)` and run by
`python -m yasph2d_tpu_torch run --config cfg.json` (__main__.py);
utils/checkpoint.py saves and loads carries in the JAX package's .npz layout.
"""

from .config import SimulationConfig
from .models.dfsph_dense import DFSPHPaddedSolver
from .models.dfsph_plane import DFSPHPlaneSolver
from .models.viscosity import PhysicalViscosityModel, XSPHViscosityModel
from .models.wcsph_dense import WCSPHPaddedSolver
from .models.wcsph_plane import WCSPHPlaneSolver
from .timemanager import AdaptiveTimeStep, FixedTimeStep
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .world import FluidParticleWorld

__all__ = [
    "AdaptiveTimeStep",
    "DFSPHPaddedSolver",
    "DFSPHPlaneSolver",
    "FixedTimeStep",
    "FluidParticleWorld",
    "PhysicalViscosityModel",
    "SimulationConfig",
    "WCSPHPaddedSolver",
    "WCSPHPlaneSolver",
    "XSPHViscosityModel",
    "load_checkpoint",
    "save_checkpoint",
]
