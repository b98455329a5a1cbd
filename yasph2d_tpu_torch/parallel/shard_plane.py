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
  shards, the CFL velocity a max (shard_dense._SpatialCollectives); the
  driver is the padded route's (shard_dense._ShardedBase), whose solver
  keywords reach the shard solver: `fuse_loop_elementwise=False` /
  `fuse_ctx_elementwise=False` run the unfused DFSPH step on the halo forms
  of K1's `ctx`, `visc`, `div` and `corr`.

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

from ..models.dfsph_dense import BoundaryDense
from ..models.dfsph_plane import DFSPHPlaneSolver
from ..models.wcsph_plane import WCSPHPlaneSolver
from ..ops.dense_grid import DenseGridConfig
from .comm import SpaceGroup
from .shard_dense import _ShardedBase, _SpatialCollectives, make_local_grid


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
    """The plane solvers' sharding hooks: the neighbour shards' halo rows of
    (..., ny, nx) planes for every geometry, pass and re-bucket."""

    _ROW_DIM = -2


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


class _ShardedPlaneBase(_ShardedBase):
    """The shared driver with the plane solvers' local grid and boundary
    planes (their seam rows exchanged); `init` returns (carry, boundary
    planes)."""

    _local_grid = staticmethod(make_local_plane_grid)

    def _boundary(self, local: BoundaryDense):
        return self.solver.boundary_planes(local)


class ShardedDFSPHPlane(_ShardedPlaneBase):
    SOLVER_CLS = DFSPHPlaneShardSolver


class ShardedWCSPHPlane(_ShardedPlaneBase):
    SOLVER_CLS = WCSPHPlaneShardSolver
