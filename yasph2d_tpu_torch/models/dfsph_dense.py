"""DFSPH on the dense slot grid: the parts the plane solver builds on (PyTorch
port of yasph2d_tpu/models/dfsph_dense.py; algorithm: Bender & Koschier,
reference src/sph/solver/dfsph.rs).

Ported: the static boundary index space (`build_boundary_dense`), the padded
initial layout of `DFSPHPaddedSolver.init_carry` (sort, slot grid, padded
positions and velocities, zero warm starts), the live count and `simulate`.
The sorted-carry `DFSPHDenseSolver` step and the XLA pair passes are not
ported: the plane solver (models/dfsph_plane.py) runs every pass through the
pair kernel.
"""

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.dense_grid import (
    DenseGridConfig,
    build_slot_grid,
    cell_keys,
    pad_to_slots,
    sort_by_dense_keys,
)
from ..ops.smoothing_kernels import WendlandQuinticC2
from ..timemanager import StepConfig, TimeState
from ..units import INDEX, REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import GRAVITY, FluidProperties, ParticleState
from .viscosity import ViscosityModel

ALPHA_EPSILON = 1e-6  # dfsph.rs:71


class BoundaryDense(NamedTuple):
    """Static (boundary) index space in dense layout; built on boundary change."""

    pos_pad: torch.Tensor  # (ny, nx, Pb, 2)
    mask: torch.Tensor  # (ny, nx, Pb) bool
    num_dropped: torch.Tensor  # () int32


def build_boundary_dense(boundary_positions: torch.Tensor, grid: DenseGridConfig,
                         occupancy=None) -> BoundaryDense:
    """Build the static index space. `occupancy=None` sizes the slot axis to the
    boundary's true maximum cell occupancy, rounded up to even."""
    keys = cell_keys(boundary_positions, grid)
    if occupancy is None:
        keys_host = keys.cpu().numpy()
        counts = np.bincount(keys_host) if keys_host.size else np.zeros(1, np.int64)
        occupancy = max(int(counts.max()), 1)
        occupancy += (-occupancy) % 2
    bgrid = dataclasses.replace(grid, occupancy=occupancy)
    keys = cell_keys(boundary_positions, bgrid)
    sorted_keys, order = torch.sort(keys, stable=True)
    slots = build_slot_grid(sorted_keys, bgrid)
    return BoundaryDense(
        pos_pad=pad_to_slots(boundary_positions[order], slots, bgrid),
        mask=slots.slot_mask.reshape(bgrid.ny, bgrid.nx, occupancy),
        num_dropped=slots.num_dropped,
    )


class PaddedInit(NamedTuple):
    """Initial state in the dense (ny, nx, P) slot layout."""

    pos_pad: torch.Tensor  # (ny, nx, P, 2)
    mask: torch.Tensor  # (ny, nx, P) bool
    v_pad: torch.Tensor  # (ny, nx, P, 2)
    kappa_pad: torch.Tensor  # (ny, nx, P) density-loop warm start
    stiff_pad: torch.Tensor  # (ny, nx, P) divergence-loop warm start
    num_dropped: torch.Tensor  # () int32: fluid + boundary cell overflow
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


@dataclass(frozen=True)
class DFSPHPaddedSolver:
    """Configuration and the padded-layout init (tolerances as dfsph.rs:49-55)."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: DenseGridConfig
    step_config: StepConfig
    max_avg_density_error: float = 0.01 / 100.0
    max_density_iterations: int = 200
    max_divergence_error: float = 0.1 / 100.0
    max_divergence_iterations: int = 400
    gravity: tuple = GRAVITY

    def __post_init__(self):
        object.__setattr__(
            self, "kernel", WendlandQuinticC2(self.properties.smoothing_length)
        )
        assert abs(self.grid.cell_size - self.properties.smoothing_length) < 1e-12

    def _padded_init(self, state: ParticleState, boundary: BoundaryDense) -> PaddedInit:
        """DFSPHPaddedSolver.init_carry's layout (via DFSPHDenseSolver.init_carry):
        cell-sort, slot grid, padded positions/velocities, zero warm starts."""
        g = self.grid
        (positions, velocities), sorted_keys = sort_by_dense_keys(
            (state.positions, state.velocities), state.positions, g, state.alive
        )
        slots = build_slot_grid(sorted_keys, g)
        zeros = torch.zeros((g.ny, g.nx, g.occupancy), dtype=REAL,
                            device=positions.device)
        return PaddedInit(
            pos_pad=pad_to_slots(positions, slots, g),
            mask=slots.slot_mask.reshape(g.ny, g.nx, g.occupancy),
            v_pad=pad_to_slots(velocities, slots, g),
            kappa_pad=zeros,
            stiff_pad=zeros.clone(),
            num_dropped=(slots.num_dropped + boundary.num_dropped).to(INDEX),
            prev_density_iterations=1,
            prev_divergence_iterations=0,
            time=TimeState.initial(self.step_config),
        )

    def _count_live(self, mask: torch.Tensor) -> np.float32:
        """Live-particle count, the residual-average denominator (the reference
        averages over its exact particle count, dfsph.rs:221, 376-377)."""
        return REAL_NP(int(mask.sum()))

    def simulate(self, carry, boundary, num_steps: int):
        """Run `num_steps` steps; the returned Diagnostics aggregates all of them
        (Diagnostics.accumulate). Each step's dt is accounted before it runs."""
        agg = Diagnostics.zeros()
        for _ in range(num_steps):
            carry = carry._replace(time=carry.time.account_step())
            carry, diag = self.step(carry, boundary)
            agg = agg.accumulate(diag)
        return carry, agg
