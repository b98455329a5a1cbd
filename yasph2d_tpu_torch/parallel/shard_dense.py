"""Spatial decomposition over cell rows (PyTorch port of the JAX package's
parallel/shard_dense.py), over `torch.distributed` (parallel/comm.py) instead
of `shard_map`:

- the dense grid's cell rows split evenly over the shards, one process each;
  a shard's grid is the global grid with its own row count and the global
  origin, its first global row `row0 = rank * ny`;
- every pair pass fetches its source rows -1 and ny from the neighbour shards
  (comm.SpaceGroup.halo_rows, one packed exchange pair) and runs its kernel's
  halo form; the re-bucket's halo rows are the migration between shards;
- the residual averages of the pressure loops are sums of per-shard partial
  sums (the reference's `par_iter().sum() / len`, dfsph.rs:221, 376-377), so
  that every shard leaves a loop on the same iteration; the CFL velocity is a
  max, the drop counts sums;
- the initial cell sort runs on each shard's own rows, with cells taken
  against the global origin and clamped to the global rows, then to the
  shard's (JAX `_SpatialCollectives._sort`).

Two shard routes share these collectives and one driver (`_ShardedBase`):

- **DFSPHPaddedShardSolver / ShardedDFSPHPadded** and **WCSPHPaddedShardSolver
  / ShardedWCSPHPadded** (here): the padded steps (models/dfsph_dense.py,
  models/wcsph_dense.py) on K5's and K4's halo forms. The fluid's rows are
  exchanged once per pair context, the boundary's once at init, the source
  values' once per pass; a particle that advects across the seam is
  re-bucketed into the neighbour's edge row through K4's halo rows, with no
  buffers and no caps (a step moves at most an edge row's slots across a seam
  each way, the JAX contract; overflow is an ordinary drop). The JAX package
  runs these passes in XLA under `shard_map` (`dense_grid.pair_reduce` with
  `halo_axis`, `rebucket(row0=...)`); its K5 route (`use_pallas`) would pad
  zeros where the neighbour's rows belong, which the port does not copy. The
  slot-major route (K3) has no halo form there and is refused here too. With
  `rebuild_every > 1` a stale step keeps the slot layout, so shard assignment
  is frozen until the next rebuild, as in JAX (a particle that crossed the
  seam stays in the old shard's edge cells). On a `full_grid` with
  `pair_dtype="bfloat16"` the passes are K5's bf16 math mode in its halo
  form: each shard rebases its positions on its global cell rows
  (`row0`), and the halo rows on the neighbours' rows, as the JAX XLA
  route rebases before it exchanges.
- **the plane route** (parallel/shard_plane.py): K1's and K2's halo forms.

The result is the one-device step's on the same grid: the same iterations and
drops and the same live rows bit for bit. A residual average is a sum of
per-shard sums, so it could differ from the one-device sum in its last bits
and move a loop's exit; the runs measured so far (the CPU test scenes, the
100k dam-break on the H100) agreed to the last bit.

SPMD: every process builds the driver with its own SpaceGroup and the same
scene, e.g. inside `comm.spawn`:

    def run(group, world, steps):
        full_grid = world.dense_grid(occupancy=7, ny_multiple=group.size)
        sharded = ShardedDFSPHPadded(group, viscosity_model=..., properties=...,
                                     full_grid=full_grid, step_config=...)
        carry, boundary = sharded.init(world.initial_state(device=group.device),
                                       world.boundary_dense(full_grid, device=group.device))
        carry, diag = sharded.simulate(carry, boundary, steps)
        return sharded.gather_live_rows(carry).cpu()

    rows = comm.spawn(run, 2, "gloo", ["cuda:0", "cuda:0"], world, 20)[0]

Not ported: the sorted-carry `DFSPHShardMapSolver` / `ShardedDFSPHDense` and
their bounded migration buffers (the port has no sorted carry); `SPACE_AXIS`
and `make_space_mesh`, the names of a `shard_map` mesh (here the process
group is the axis).
"""

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.dfsph_dense import BoundaryDense, DFSPHPaddedSolver
from ..models.wcsph_dense import WCSPHPaddedSolver
from ..ops.dense_grid import DenseGridConfig, cell_coords, sort_by_dense_keys
from ..ops.planes import Halo
from ..units import REAL_NP
from ..world import ParticleState
from .comm import SpaceGroup


def make_local_grid(full_grid: DenseGridConfig, n_shards: int) -> DenseGridConfig:
    """One shard's grid: `full_grid` with ny the shard's row count; the origin
    stays global (a shard's rows start at its `row0`)."""
    if full_grid.ny % n_shards:
        raise ValueError(f"grid ny={full_grid.ny} must divide over {n_shards} shards "
                         "(build with world.dense_grid(ny_multiple=n_shards))")
    return dataclasses.replace(full_grid, ny=full_grid.ny // n_shards)


def distribute(state: ParticleState, full_grid: DenseGridConfig,
               n_shards: int) -> List[ParticleState]:
    """Host side: the live particles of `state` bucketed by the shard that owns
    their cell row, in input order; one ParticleState per shard. The cell row
    is the f32 one the solvers compute (dense_grid.cell_coords), so no
    particle starts on a shard that does not own its cell. The JAX version
    pads each block to a fixed capacity for shard_map; the port's shapes
    need not be equal."""
    ny_l = full_grid.ny // n_shards
    _, cy = cell_coords(state.positions, full_grid)
    shard = torch.clamp(cy // ny_l, 0, n_shards - 1)
    blocks = []
    for d in range(n_shards):
        sel = torch.nonzero((shard == d) & state.alive).reshape(-1)
        blocks.append(ParticleState(
            positions=state.positions[sel], velocities=state.velocities[sel],
            densities=state.densities[sel], alive=state.alive[sel]))
    return blocks


class _SpatialCollectives:
    """The shard solvers' overrides of the one-device hooks of
    models/dfsph_dense.py, reduced over the shards through `self.group` (a
    comm.SpaceGroup). The host classes carry the shard's grid
    (make_local_grid); `_ROW_DIM` is the row axis of their state's tensors."""

    _ROW_DIM = 0  # the padded carry: (ny, nx, P, ...)

    @property
    def _n_shards(self) -> int:
        return self.group.size

    def _rebucket_row0(self) -> int:
        return self.group.rank * self.grid.ny

    def _halo(self, tensors) -> Optional[Halo]:
        """The neighbours' rows -1 and ny of `tensors`, one exchange; None on a
        one-shard mesh, whose halo rows would all be dead: the one-device
        kernels run there."""
        if self.group.size == 1:
            return None
        below, above = self.group.halo_rows(tensors, self._ROW_DIM)
        rows = tuple(torch.cat([b, a], dim=self._ROW_DIM) for b, a in zip(below, above))
        return Halo(rows, self._rebucket_row0(), self.grid.ny * self._n_shards)

    def _sort(self, tensors, positions, alive):
        """The cell sort on this shard's rows: cells against the global origin,
        clamped to the global rows, then to the shard's; a particle outside
        the shard's rows lands in its edge row."""
        return sort_by_dense_keys(tensors, positions, self.grid, alive,
                                  row0=self._rebucket_row0(),
                                  ny_total=self.grid.ny * self._n_shards)

    def _mean_live(self, value, ctx, n_particles) -> np.float32:
        # the reference's global residual average: the sum of the shards'
        # partial sums, so every shard takes the same loop exit
        total = self.group.sum(torch.where(ctx.mask, value, 0.0).sum())
        return REAL_NP(float(total)) / REAL_NP(n_particles)

    def _count_live(self, mask: torch.Tensor) -> np.float32:
        return REAL_NP(int(self.group.sum(mask.sum())))

    def _max_vel_from_sq(self, v_est_sq) -> np.float32:
        # the CFL velocity: the largest over the shards
        return REAL_NP(float(torch.sqrt(self.group.max(v_est_sq.max()))))

    def _sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        return self.group.sum(count)


class _PaddedCollectives(_SpatialCollectives):
    """The padded solvers' sharding hooks; K5 is their only pair kernel with
    a halo form."""

    def __post_init__(self):
        if self.grid.use_pallas_slotmajor:
            # the JAX package's assert (models/dfsph_dense.py, wcsph_dense.py)
            raise ValueError("the vector-last slot-major (sm_*) path has no halo "
                             "collectives; sharded slot-major runs through the plane-form "
                             "solvers (parallel/shard_plane.py)")
        super().__post_init__()


@dataclasses.dataclass(frozen=True)
class DFSPHPaddedShardSolver(_PaddedCollectives, DFSPHPaddedSolver):
    """The padded DFSPH step on one shard; `grid` is the shard's
    (make_local_grid), `group` its SpaceGroup."""

    group: SpaceGroup = None


@dataclasses.dataclass(frozen=True)
class WCSPHPaddedShardSolver(_PaddedCollectives, WCSPHPaddedSolver):
    """The padded WCSPH step on one shard: the halo exchanges, the CFL max and
    the drop sum are its only collectives (WCSPH has no residual loops)."""

    group: SpaceGroup = None


class _ShardedBase:
    """One process's driver of a shard solver (the JAX `ShardedDFSPHDense`
    base): distributes the scene, builds the shard's boundary and carry,
    steps them, and gathers the global state. Subclasses name the solver
    class, the local grid and the solver's boundary operand."""

    SOLVER_CLS = None

    def __init__(self, group: SpaceGroup, viscosity_model, properties,
                 full_grid: DenseGridConfig, step_config, **solver_kwargs):
        self.group = group
        self.full_grid = full_grid
        self.solver = self.SOLVER_CLS(
            viscosity_model=viscosity_model, properties=properties,
            grid=self._local_grid(full_grid, group.size), step_config=step_config,
            group=group, **solver_kwargs,
        )

    @staticmethod
    def _local_grid(full_grid: DenseGridConfig, n_shards: int) -> DenseGridConfig:
        return make_local_grid(full_grid, n_shards)

    def local_boundary(self, boundary: BoundaryDense) -> BoundaryDense:
        """This shard's rows of the full grid's boundary index space; the drop
        count stays the full build's."""
        r0, ny = self.solver._rebucket_row0(), self.solver.grid.ny
        return boundary._replace(pos_pad=boundary.pos_pad[r0:r0 + ny],
                                 mask=boundary.mask[r0:r0 + ny])

    def _boundary(self, local: BoundaryDense):
        """The solver's boundary operand of this shard's rows: the padded
        solvers take them with the neighbours' rows (one exchange)."""
        return local._replace(halo=self.solver._halo((local.pos_pad, local.mask)))

    def init(self, state: ParticleState, boundary: BoundaryDense):
        """(carry, boundary) of this shard. `state` is the whole scene and
        `boundary` the full grid's (world.boundary_dense(full_grid)), the same
        on every shard; pass the returned boundary to step / simulate."""
        local = distribute(state, self.full_grid, self.group.size)[self.group.rank]
        b = self._boundary(self.local_boundary(boundary))
        return self.solver.init_carry(local, b), b

    # step / simulate: the API of the JAX sharded classes, so that a sharded run
    # is driven as a one-device solver is
    def step(self, carry, boundary):
        return self.solver.step(carry, boundary)

    def simulate(self, carry, boundary, num_steps: int):
        return self.solver.simulate(carry, boundary, num_steps)

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


class ShardedDFSPHPadded(_ShardedBase):
    """The padded DFSPH solver over the spatial group (JAX ShardedDFSPHPadded)."""

    SOLVER_CLS = DFSPHPaddedShardSolver


class ShardedWCSPHPadded(_ShardedBase):
    """The padded WCSPH solver over the spatial group (JAX ShardedWCSPHPadded)."""

    SOLVER_CLS = WCSPHPaddedShardSolver
