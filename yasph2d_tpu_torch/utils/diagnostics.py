"""Per-step diagnostics (PyTorch port of yasph2d_tpu/utils/diagnostics.py).

The reference surfaces solver health as printlns (non-convergence warnings,
dfsph.rs:236-245/391-400; neighbor overflow, neighborhood_search.rs:361). Every
solver step returns a `Diagnostics` of host scalars; the port's step reads them
back anyway to drive its pressure loops.
"""

from typing import NamedTuple

import numpy as np

from ..units import REAL_NP


class Diagnostics(NamedTuple):
    dt: np.float32  # dt used to advance this step
    max_velocity: np.float32  # CFL velocity estimate
    neighbor_drops: int  # particles lost to cell overflow
    density_iterations: int  # DFSPH density loop count
    divergence_iterations: int  # DFSPH divergence loop count
    avg_density_error: np.float32  # last density residual (abs, kg/m^2)
    avg_divergence: np.float32  # last divergence residual (relative, 1/s)
    migration_drops: int  # cross-shard migration losses (0 on one device)

    @classmethod
    def zeros(cls) -> "Diagnostics":
        f = REAL_NP(0.0)
        return cls(f, f, 0, 0, 0, f, f, 0)

    def accumulate(self, step: "Diagnostics") -> "Diagnostics":
        """Fold one step into a running aggregate: dt = last step's; max
        velocity, drops and residuals = max over steps; iteration counts = sum
        over steps (np.maximum propagates NaN, like jnp.maximum)."""
        return Diagnostics(
            dt=step.dt,
            max_velocity=np.maximum(self.max_velocity, step.max_velocity),
            neighbor_drops=max(self.neighbor_drops, step.neighbor_drops),
            density_iterations=self.density_iterations + step.density_iterations,
            divergence_iterations=(
                self.divergence_iterations + step.divergence_iterations
            ),
            avg_density_error=np.maximum(
                self.avg_density_error, step.avg_density_error
            ),
            avg_divergence=np.maximum(self.avg_divergence, step.avg_divergence),
            migration_drops=max(self.migration_drops, step.migration_drops),
        )
