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

Three shard routes share these collectives and one driver (`_ShardedBase`):

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
- **DFSPHShardMapSolver / ShardedDFSPHDense** (here; JAX's conformance
  bridge): the sorted step (models/dfsph_dense.DFSPHDenseSolver) on each
  shard's block of a fixed capacity (dead rows behind the live ones), its
  pair passes on K5's halo forms through the same hooks (a bf16 grid:
  K5's bf16 halo form, rebased on the shard's global rows). Each rebuild
  first migrates: the particles whose global cell row left the shard's
  rows go to the neighbour shard, at most `migration_slots` each way, in
  one (m, K+1) f32 buffer a direction (the carry's packed columns and a
  valid flag) through one exchange pair (`SpaceGroup.shift`), the senders
  taken in block order (a stable sort) and the rest left alive where they
  are until a later rebuild; the shard's rows, then the arrivals from
  below and from above, are compacted live-first (stable) into the
  block's fixed rows. The senders left behind and the live rows beyond the
  capacity (those are lost) are `Diagnostics.migration_drops`, summed
  over the shards. The JAX route (shard_dense.py:170-438) is this,
  operation for operation; with `grid.use_pallas` its passes would pad
  zeros where the neighbour's rows belong, which the port does not copy.
  The result is the one-device sorted step's iterations and drops, and its
  positions to f32 drift, not bit for bit: an arrival is appended behind
  the shard's rows before the stable cell sort, so it can take another
  slot in its cell than on one device, and K5 sums in slot order.
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

The loop-gradient variants (`cache_loop_gradients`, `mxu_loop_gradients`)
are refused under sharding: their cached pair map has no halo exchange.

Not ported: `SPACE_AXIS` and `make_space_mesh`, the names of a `shard_map`
mesh (here the process group is the axis).
"""

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.dfsph_dense import BoundaryDense, DenseCtx, DFSPHDenseSolver, DFSPHPaddedSolver
from ..models.wcsph_dense import WCSPHPaddedSolver
from ..ops.dense_grid import DenseGridConfig, cell_coords, sort_by_dense_keys
from ..ops.planes import Halo
from ..units import REAL, REAL_NP
from ..utils.profiling import read_back
from ..world import ParticleState
from .comm import SpaceGroup


def make_local_grid(full_grid: DenseGridConfig, n_shards: int) -> DenseGridConfig:
    """One shard's grid: `full_grid` with ny the shard's row count; the origin
    stays global (a shard's rows start at its `row0`)."""
    if full_grid.ny % n_shards:
        raise ValueError(f"grid ny={full_grid.ny} must divide over {n_shards} shards "
                         "(build with world.dense_grid(ny_multiple=n_shards))")
    return dataclasses.replace(full_grid, ny=full_grid.ny // n_shards)


def _owners(state: ParticleState, full_grid: DenseGridConfig, n_shards: int):
    """The shard that owns each particle's cell row (the f32 row the solvers
    compute, dense_grid.cell_coords), and each shard's live count."""
    _, cy = cell_coords(state.positions, full_grid)
    shard = torch.clamp(cy // (full_grid.ny // n_shards), 0, n_shards - 1)
    return shard, torch.bincount(shard[state.alive], minlength=n_shards)


def default_capacity(state: ParticleState, full_grid: DenseGridConfig, n_shards: int) -> int:
    """The sorted route's rows a shard (JAX ShardedDFSPHDense.distribute):
    the fullest shard's live count with a quarter of slack for migration,
    plus 64."""
    return int(int(_owners(state, full_grid, n_shards)[1].max()) * 1.25) + 64


def distribute(state: ParticleState, full_grid: DenseGridConfig, n_shards: int,
               capacity: Optional[int] = None) -> List[ParticleState]:
    """Host side: the live particles of `state` bucketed by the shard that owns
    their cell row, in input order; one ParticleState per shard. The cell row
    is the f32 one the solvers compute (dense_grid.cell_coords), so no
    particle starts on a shard that does not own its cell. With a `capacity`
    (the sorted route's fixed rows a shard) each block is padded with dead
    rows (zeros, alive False) to that length, as in JAX, and a shard with
    more live particles raises; without one the blocks hold the live rows
    only (the padded and plane routes)."""
    shard, counts = _owners(state, full_grid, n_shards)
    if capacity is not None and int(counts.max()) > capacity:
        raise ValueError(f"shard overflow: {int(counts.max())} live particles > "
                         f"capacity {capacity}")
    blocks = []
    for d in range(n_shards):
        sel = torch.nonzero((shard == d) & state.alive).reshape(-1)
        block = ParticleState(*(t[sel] for t in state))
        if capacity is not None:
            block = ParticleState(*(torch.cat([t, t.new_zeros((capacity - t.shape[0],)
                                                               + tuple(t.shape[1:]))])
                                    for t in block))
        blocks.append(block)
    return blocks


class _SpatialCollectives:
    """The shard solvers' overrides of the one-device hooks of
    models/slot_solver.py, reduced over the shards through `self.group` (a
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

    def _count_live(self, mask: torch.Tensor) -> np.float32:
        return REAL_NP(read_back("live_count", self.group.sum(mask.sum())))

    def _max_vel_from_sq(self, v_est_sq) -> np.float32:
        # the CFL velocity: the largest over the shards
        return REAL_NP(read_back("max_velocity", torch.sqrt(self.group.max(v_est_sq.max()))))

    def _sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        # the drop counts, and the residuals' sums (`_mean_of_sum`): the
        # reference's global average is the sum of the shards' partial sums,
        # so every shard takes the same loop exit
        return self.group.sum(count)

    def _local_sums(self) -> bool:
        # the residuals' totals are global: the pressure loops test them on
        # the host
        return False


class _SlotCollectives(_SpatialCollectives):
    """The slot-layout (padded and sorted) solvers' sharding hooks; K5 is
    their only pair kernel with a halo form."""

    def __post_init__(self):
        if self.grid.use_pallas_slotmajor:
            # the JAX package's assert (models/dfsph_dense.py, wcsph_dense.py)
            raise ValueError("the vector-last slot-major (sm_*) path has no halo "
                             "collectives; sharded slot-major runs through the plane-form "
                             "solvers (parallel/shard_plane.py)")
        super().__post_init__()


class _DFSPHCollectives(_SlotCollectives):
    """The DFSPH slot solvers' sharding hooks: the loop-gradient variants
    have no halo form."""

    def _check_loop_gradients(self):
        if self.mxu_loop_gradients:
            # the JAX package's assert (models/dfsph_dense.py:199-202)
            raise ValueError("mxu_loop_gradients under sharding: pair_map has no halo "
                             "exchange (a one-device variant)")
        if self.cache_loop_gradients:
            # JAX runs it, its pair_map zero-padding the neighbour's rows
            raise ValueError("cache_loop_gradients under sharding: the cached pair map has "
                             "no halo exchange, so an edge row would lose its neighbours "
                             "across the seam")
        super()._check_loop_gradients()


@dataclasses.dataclass(frozen=True)
class DFSPHPaddedShardSolver(_DFSPHCollectives, DFSPHPaddedSolver):
    """The padded DFSPH step on one shard; `grid` is the shard's
    (make_local_grid), `group` its SpaceGroup."""

    group: SpaceGroup = None


@dataclasses.dataclass(frozen=True)
class WCSPHPaddedShardSolver(_SlotCollectives, WCSPHPaddedSolver):
    """The padded WCSPH step on one shard: the halo exchanges, the CFL max and
    the drop sum are its only collectives (WCSPH has no residual loops)."""

    group: SpaceGroup = None


@dataclasses.dataclass(frozen=True)
class DFSPHShardMapSolver(_DFSPHCollectives, DFSPHDenseSolver):
    """The sorted DFSPH step on one shard's block (module docstring); `grid`
    is the shard's (make_local_grid), `group` its SpaceGroup. After each
    step `last_migration` holds the particles this shard sent up and down
    at its last rebuild (0-d tensors)."""

    group: SpaceGroup = None
    migration_slots: int = 256

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "last_migration", {})

    def _migrate(self, tree, positions, alive):
        """Bounded migration to the neighbour shards (JAX
        DFSPHShardMapSolver._migrate, operation for operation). `tree` is
        (*data, alive), data (N, ...) per-particle tensors; returns the new
        tree (the same N rows) and the migration drops summed over the
        shards."""
        g = self.grid
        m = self.migration_slots
        n_local = positions.shape[0]
        _, cy = cell_coords(positions, dataclasses.replace(g, ny=g.ny * self._n_shards))
        ly = cy - self._rebucket_row0()
        *data, _ = tree

        def pack(flags):
            # senders first, in block order (a stable sort), the first m sent
            idx = torch.argsort((~flags).to(torch.uint8), stable=True)[:m]
            valid = flags[idx]
            unsent = flags.sum() - valid.sum()
            packed = torch.cat([a[idx].reshape(idx.shape[0], -1).to(REAL) for a in data]
                               + [valid[:, None].to(REAL)], dim=1)
            if idx.shape[0] < m:  # a block of fewer than m rows: empty buffer rows
                packed = torch.cat([packed, packed.new_zeros((m - idx.shape[0],
                                                              packed.shape[1]))])
            sent = torch.zeros_like(flags)
            sent[idx] = valid
            return packed, sent, unsent

        def unpack(buf):
            out, o = [], 0
            for a in data:
                k = int(np.prod(a.shape[1:], dtype=np.int64))
                out.append(buf[:, o:o + k].reshape((m,) + tuple(a.shape[1:])).to(a.dtype))
                o += k
            return out, buf[:, -1] > 0.5

        up, sent_up, unsent_up = pack(alive & (ly >= g.ny))
        down, sent_down, unsent_down = pack(alive & (ly < 0))
        # one exchange pair: up to the next shard, down to the previous; the
        # ends of the mesh receive zeros (valid 0)
        (from_below,), (from_above,) = self.group.shift([up], [down])
        below, valid_below = unpack(from_below)
        above, valid_above = unpack(from_above)

        # the shard's rows, then the arrivals from below and from above,
        # compacted live-first (stable) into the block's fixed rows; the
        # live rows beyond them are lost and counted
        stay = alive & ~sent_up & ~sent_down
        big = [torch.cat([a, b, c]) for a, b, c in zip(data, below, above)]
        big_alive = torch.cat([stay, valid_below, valid_above])
        keep = torch.argsort((~big_alive).to(torch.uint8), stable=True)[:n_local]
        kept_alive = big_alive[keep]
        capacity_drops = big_alive.sum() - kept_alive.sum()
        drops = self.group.sum(unsent_up + unsent_down + capacity_drops)
        self.last_migration.update(up=sent_up.sum(), down=sent_down.sum())
        return tuple(a[keep] for a in big) + (kept_alive,), int(drops)


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
        local = distribute(state, self.full_grid, self.group.size,
                           self._capacity(state))[self.group.rank]
        b = self._boundary(self.local_boundary(boundary))
        return self.solver.init_carry(local, b), b

    def _capacity(self, state: ParticleState) -> Optional[int]:
        """The rows of a shard's block: the live rows only (None)."""
        return None

    # step / simulate: the API of the JAX sharded classes, so that a sharded run
    # is driven as a one-device solver is
    def step(self, carry, boundary):
        return self.solver.step(carry, boundary)

    def simulate(self, carry, boundary, num_steps: int):
        return self.solver.simulate(carry, boundary, num_steps)

    def resume(self, carry):
        """A DFSPH slot carry (padded or sorted) loaded from a checkpoint or
        converted from the JAX package's leaves, with its pair context's halo
        rows exchanged anew: a checkpoint holds none (the JAX carry has no
        such field), and the first passes of a step read them."""
        if not isinstance(getattr(carry, "ctx", None), DenseCtx):
            raise TypeError(f"resume takes a DFSPH slot carry, got {type(carry).__name__}")
        ctx = carry.ctx
        return carry._replace(ctx=ctx._replace(halo=self.solver._halo((ctx.pos_pad, ctx.mask))))

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


class ShardedDFSPHDense(_ShardedBase):
    """The sorted DFSPH solver over the spatial group (JAX ShardedDFSPHDense):
    each shard's block has `capacity` rows (None: default_capacity of the
    scene), and each rebuild migrates at most `migration_slots` particles
    each way. `export_state` gathers every shard's block (capacity rows
    each, dead rows included) in shard order; `gather_live_rows` its live
    rows."""

    SOLVER_CLS = DFSPHShardMapSolver

    def __init__(self, group: SpaceGroup, viscosity_model, properties,
                 full_grid: DenseGridConfig, step_config, capacity: Optional[int] = None,
                 migration_slots: int = 256, **solver_kwargs):
        super().__init__(group, viscosity_model, properties, full_grid, step_config,
                         migration_slots=migration_slots, **solver_kwargs)
        self.capacity = capacity

    def _capacity(self, state: ParticleState) -> int:
        return self.capacity or default_capacity(state, self.full_grid, self.group.size)
