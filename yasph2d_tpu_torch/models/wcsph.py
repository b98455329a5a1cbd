"""WCSPH equation of state (PyTorch port of the Tait part of
yasph2d_tpu/models/wcsph.py; Becker & Teschner 2007, reference:
src/sph/solver/wscsph.rs:26-57).

The solvers are in models/wcsph_dense.py (padded slot-major carry) and
models/wcsph_plane.py (plane carry). The table-layout WCSPHSolver is not
ported.
"""

import torch

from ..units import REAL
from ..world import FluidProperties

# gamma hardcoded to 7 as proposed in the paper (reference: wscsph.rs:26)
TAIT_EQUATION_GAMMA = 7


def compute_stiffness(
    properties: FluidProperties,
    target_density_variation: float = 0.01,
    expected_max_flow_speed: float = 1.0,
) -> float:
    """B = rho0 * c^2 / gamma with c = v_max / sqrt(eta), a Python double
    (reference: set_compressibility, wscsph.rs:45-49; defaults from wscsph.rs:39)."""
    speed_of_sound = expected_max_flow_speed / (target_density_variation**0.5)
    return properties.fluid_density * speed_of_sound**2 / TAIT_EQUATION_GAMMA


def tait_pressure(stiffness, fluid_density, local_density: torch.Tensor):
    """Tait EOS with pressure clamp for particle deficiency
    (reference: wscsph.rs:52-57), in the JAX package's f32 operations: the
    ratio divides by a tensor (a Python divisor becomes a reciprocal multiply
    on CUDA) and ratio**7 is XLA's integer_pow expansion."""
    rho0 = torch.tensor(fluid_density, dtype=REAL, device=local_density.device)
    ratio = torch.clamp(local_density / rho0, min=1.0)
    r2 = ratio * ratio
    r3 = ratio * r2
    r4 = r2 * r2
    return float(stiffness) * (r3 * r4 - 1.0)
