"""Spatial decomposition over cell rows: the parts of the JAX package's
parallel/shard_dense.py that the sharded plane solvers (parallel/shard_plane.py)
are built on, over `torch.distributed` (parallel/comm.py) instead of
`shard_map`.

- the dense grid's cell rows split evenly over the shards, one process each;
  a shard's grid is the global grid with its own row count and the global
  origin, its first global row `row0 = rank * ny`;
- the residual averages of the pressure loops are sums of per-shard partial
  sums (the reference's `par_iter().sum() / len`, dfsph.rs:221, 376-377), so
  that every shard leaves a loop on the same iteration; the CFL velocity is a
  max, the drop counts sums;
- the initial cell sort runs on each shard's own rows, with cells taken
  against the global origin and clamped to the global rows, then to the
  shard's (JAX `_SpatialCollectives._sort`).

Not ported: the sorted-carry `DFSPHShardMapSolver` and its bounded migration
buffers (the port has no sorted carry); the padded shard solvers and drivers
(`ShardedDFSPHPadded`, `ShardedWCSPHPadded`), whose kernels' halo forms (K4,
K5) are still to come; `SPACE_AXIS` and `make_space_mesh`, the names of a
`shard_map` mesh (here the process group is the axis).
"""

import dataclasses
from typing import List

import numpy as np
import torch

from ..ops.dense_grid import DenseGridConfig, cell_coords, sort_by_dense_keys
from ..units import REAL_NP
from ..world import ParticleState

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
    models/dfsph_dense.py and models/dfsph_plane.py, reduced over the
    shards through `self.group` (a comm.SpaceGroup). The host classes carry
    the shard's grid (make_local_grid)."""

    @property
    def _n_shards(self) -> int:
        return self.group.size

    def _rebucket_row0(self) -> int:
        return self.group.rank * self.grid.ny

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

    def _sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        return self.group.sum(count)
