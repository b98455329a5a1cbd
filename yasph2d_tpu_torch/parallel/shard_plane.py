"""Spatially sharded plane-resident solvers (PyTorch port of
yasph2d_tpu/parallel/shard_plane.py): the DFSPH and WCSPH plane steps
(models/dfsph_plane.py, models/wcsph_plane.py) with the grid's cell rows split
over processes, one shard each, and every collective outside the kernels:

- K1's source rows -1 and ny come from the neighbour shards
  (comm.SpaceGroup.halo_rows, one packed exchange pair): the geometry's once
  per rebuild (kept in PlaneCtx.geom), the boundary's once at init, the
  source values' once per pass, as the JAX `_pf_halo` calls are placed; in
  bf16 mode the exchanged geometry rows are the neighbour's rebased bf16
  rows, rebased on global cell rows;
- K2's halo rows are the migration between shards: a particle whose advected
  cell row crosses the seam is re-bucketed into the neighbour's edge row
  through them, with move codes against global rows (no buffers, no caps; a
  step can move at most an edge row's slots across a seam each way, the JAX
  contract);
- residual averages, the live count and the drop counts are sums over the
  shards, the CFL velocity a max (shard_dense._SpatialCollectives).

The result is the one-device step's on the same grid: the same iterations
and drops and the same live rows bit for bit. A residual average is a sum
of per-shard sums, so it could differ from the one-device sum in its last
bits and move a loop's exit; on the runs measured so far (the 3k dam-break on
the CPU, the 100k one on the H100) the averages agreed to the last bit.

SPMD: every process builds the driver with its own SpaceGroup and the same
scene, e.g. inside `comm.spawn`:

    def run(group, world, steps):
        full_grid = dataclasses.replace(
            world.dense_grid(occupancy=7, ny_multiple=group.size),
            use_pallas_slotmajor=True)
        sharded = ShardedDFSPHPlane(group, viscosity_model=..., properties=...,
                                    full_grid=full_grid, step_config=...)
        carry, boundary = sharded.init(world.initial_state(device=group.device),
                                       world.boundary_dense(full_grid, device=group.device))
        carry, diag = sharded.simulate(carry, boundary, steps)
        return sharded.gather_live_rows(carry).cpu()

    rows = comm.spawn(run, 2, "gloo", ["cuda:0", "cuda:0"], world, 20)[0]
"""

import dataclasses
from typing import Optional

import torch

from ..models.dfsph_dense import BoundaryDense
from ..models.dfsph_plane import DFSPHPlaneSolver
from ..models.wcsph_plane import WCSPHPlaneSolver
from ..ops.dense_grid import DenseGridConfig
from ..ops.planes import Halo
from ..units import REAL_NP
from ..world import ParticleState
from .comm import SpaceGroup
from .shard_dense import _SpatialCollectives, distribute, make_local_grid


def make_local_plane_grid(full_grid: DenseGridConfig, n_shards: int) -> DenseGridConfig:
    """make_local_grid for the plane solvers. The JAX version also picks a TPU
    row block dividing the shard's rows; the port's planes have no row
    blocks, so what remains is the checks: the plane solvers' slot-major
    route and at least one row a shard."""
    if not full_grid.use_pallas_slotmajor:
        raise ValueError("the sharded plane solvers need "
                         "DenseGridConfig.use_pallas_slotmajor=True")
    if n_shards > full_grid.ny:
        raise ValueError(f"{n_shards} shards for {full_grid.ny} rows")
    return make_local_grid(full_grid, n_shards)


class _PlaneCollectives(_SpatialCollectives):
    """The plane solvers' sharding hooks: the neighbour shards' halo rows for
    every geometry, pass and re-bucket, and the CFL max over the shards."""

    def _halo(self, planes) -> Optional[Halo]:
        """The neighbours' rows of `planes`; None on a one-shard mesh, whose
        halo rows would all be dead: the one-device kernels run there."""
        if self.group.size == 1:
            return None
        below, above = self.group.halo_rows(planes)
        rows = tuple(torch.cat([b, a], dim=-2) for b, a in zip(below, above))
        return Halo(rows, self._rebucket_row0(), self.grid.ny * self._n_shards)

    def _max_vel_from_sq(self, v_est_sq) -> REAL_NP:
        return REAL_NP(float(torch.sqrt(self.group.max(v_est_sq.max()))))


@dataclasses.dataclass(frozen=True)
class DFSPHPlaneShardSolver(_PlaneCollectives, DFSPHPlaneSolver):
    """The DFSPH plane step on one shard; `grid` is the shard's
    (make_local_plane_grid), `group` its SpaceGroup."""

    group: SpaceGroup = None


@dataclasses.dataclass(frozen=True)
class WCSPHPlaneShardSolver(_PlaneCollectives, WCSPHPlaneSolver):
    """The WCSPH plane step on one shard: the halo exchanges, the CFL max and
    the drop sum are its only collectives (WCSPH has no residual loops)."""

    group: SpaceGroup = None


class _ShardedPlaneBase:
    """One process's driver of a sharded plane solver: distributes the scene,
    builds the shard's boundary planes (their seam rows exchanged) and carry,
    steps them, and gathers the global state."""

    SOLVER_CLS = None

    def __init__(self, group: SpaceGroup, viscosity_model, properties,
                 full_grid: DenseGridConfig, step_config, **solver_kwargs):
        self.group = group
        self.full_grid = full_grid
        self.solver = self.SOLVER_CLS(
            viscosity_model=viscosity_model, properties=properties,
            grid=make_local_plane_grid(full_grid, group.size), step_config=step_config,
            group=group, **solver_kwargs,
        )

    def local_boundary(self, boundary: BoundaryDense) -> BoundaryDense:
        """This shard's rows of the full grid's boundary index space; the drop
        count stays the full build's."""
        r0, ny = self.solver._rebucket_row0(), self.solver.grid.ny
        return boundary._replace(pos_pad=boundary.pos_pad[r0:r0 + ny],
                                 mask=boundary.mask[r0:r0 + ny])

    def init(self, state: ParticleState, boundary: BoundaryDense):
        """(carry, boundary planes) of this shard. `state` is the whole scene and
        `boundary` the full grid's (world.boundary_dense(full_grid)), the same
        on every shard; pass the boundary planes to step / simulate."""
        local = distribute(state, self.full_grid, self.group.size)[self.group.rank]
        bpl = self.solver.boundary_planes(self.local_boundary(boundary))
        return self.solver.init_carry(local, bpl), bpl

    # step / simulate: the API of the JAX sharded classes, so that a sharded run
    # is driven as a one-device solver is
    def step(self, carry, boundary_planes):
        return self.solver.step(carry, boundary_planes)

    def simulate(self, carry, boundary_planes, num_steps: int):
        return self.solver.simulate(carry, boundary_planes, num_steps)

    def export_state(self, carry) -> ParticleState:
        """The one-device solver's export_state of the full grid (slot order:
        global row, column, slot), gathered from every shard onto each."""
        return ParticleState(*(self.group.all_gather(t)
                               for t in self.solver.export_state(carry)))

    def gather_live_rows(self, carry) -> torch.Tensor:
        """(N live, 5) rows x, y, vx, vy, density of the live particles of every
        shard, in the global slot order."""
        s = self.export_state(carry)
        rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], dim=1)
        return rows[s.alive]


class ShardedDFSPHPlane(_ShardedPlaneBase):
    SOLVER_CLS = DFSPHPlaneShardSolver


class ShardedWCSPHPlane(_ShardedPlaneBase):
    SOLVER_CLS = WCSPHPlaneShardSolver
