"""Cell-list neighbour search: cell-key sort and fixed-degree neighbour tables
(PyTorch port of yasph2d_tpu/ops/neighborhood.py; reference:
src/sph/neighborhood_search.rs).

The design is the JAX package's, in plain tensor operations on the device
(no hand-written kernel: the JAX package has none here either):

- particles sort by a row-major int32 cell key (a stable sort, as
  `jax.lax.sort` is), so that each row of a query's 3x3 cell box is one
  contiguous key run of the sorted source space;
- three binary searches per query give the runs' bounds; a window of
  `GridConfig.window` candidates per run is gathered and distance-filtered
  (dist^2 <= h^2 and > MIN_DISTANCE_SQ, neighborhood_search.rs:324);
- a cumsum compaction writes each query's valid candidates, in run order, into
  the first K slots of its row of the (N, K) table. JAX scatters with
  mode="drop" to an out-of-range index; here the rejected candidates go to one
  extra slot past the table, which is cut off.

`idx`, `mask`, `count` and `num_dropped` are the JAX tables' bit for bit: every
operation on the way is exact (integer arithmetic, f32 compares of the same
f32 values). Overflow of a window or of K is counted in `num_dropped`, never
silent (the reference only prints it, neighborhood_search.rs:361).
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..units import INDEX
from .dense_grid import f32_scalar

# Self / degenerate-pair filter (reference: neighborhood_search.rs:324).
MIN_DISTANCE_SQ = 1.0e-10


@dataclass(frozen=True)
class GridConfig:
    """The uniform cell grid of the table solvers (the JAX fields and defaults)."""

    cell_size: float  # == search radius == smoothing length h
    grid_min: tuple = (-100.0, -100.0)  # reference: neighborhood_search.rs:476-479
    # virtual row width in cells: keys are cy * row_width + cx < 2^30
    row_width: int = 1 << 15
    # fixed neighbour degrees, one per index space (the reference caps both
    # together at 64, neighborhood_search.rs:322)
    max_neighbors_dynamic: int = 64
    max_neighbors_static: int = 64
    # candidates gathered per contiguous 3-cell run (one row of the 3x3 box)
    window: int = 32

    @property
    def radius_sq(self) -> float:
        return self.cell_size * self.cell_size

    @property
    def num_rows(self) -> int:
        return (1 << 30) // self.row_width  # keep keys < 2^30


class NeighborTable(NamedTuple):
    """Fixed-degree neighbour lists of query particles into one source space."""

    idx: torch.Tensor  # (N, K) int32 into the sorted source positions
    mask: torch.Tensor  # (N, K) bool: the slot holds a real neighbour
    count: torch.Tensor  # (N,) int32 valid neighbours (after the cap)
    num_dropped: torch.Tensor  # () int32 neighbours lost to the window / K caps


class CellGrid(NamedTuple):
    """A sorted index space: positions sorted by cell key."""

    positions: torch.Tensor  # (M, 2) sorted by key
    keys: torch.Tensor  # (M,) int32 sorted cell keys


class Neighborhood(NamedTuple):
    """Both tables of the fluid particles (reference: NeighborRange,
    neighborhood_search.rs:268-287)."""

    dynamic: NeighborTable  # fluid -> fluid
    static: NeighborTable  # fluid -> boundary


def cell_keys(positions: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    """Row-major cell key per position, clamped into the virtual grid. The
    coordinates are clamped in f32 before the cast to int32 (XLA's cast
    saturates; torch's is undefined out of range), which leaves the key of
    every finite position as JAX computes it."""
    inv = f32_scalar(1.0 / grid.cell_size)
    keys = []
    for axis, hi in ((0, grid.row_width - 1), (1, grid.num_rows - 1)):
        c = torch.floor((positions[..., axis] - f32_scalar(grid.grid_min[axis])) * inv)
        keys.append(torch.clamp(c, 0.0, float(hi)).to(INDEX).clamp(1, hi - 1))
    cx, cy = keys
    return cy * grid.row_width + cx


def sort_by_cell_keys(positions: torch.Tensor, grid: GridConfig):
    """(sorted_keys, permutation): `permutation[k]` is the pre-sort index of
    the particle now in slot k (int32). The sort is stable, as jax.lax.sort."""
    sorted_keys, perm = torch.sort(cell_keys(positions, grid), stable=True)
    return sorted_keys, perm.to(INDEX)


def build_cell_grid(positions: torch.Tensor, grid: GridConfig) -> CellGrid:
    """A sorted index space (the boundary's, reference: update_static,
    neighborhood_search.rs:488-491)."""
    sorted_keys, perm = sort_by_cell_keys(positions, grid)
    return CellGrid(positions=positions[perm], keys=sorted_keys)


def _run_bounds(query_keys: torch.Tensor, source_keys: torch.Tensor, grid: GridConfig):
    """(starts, ends), each (N, 3) int32: the source runs of the cells
    (cy + dy, cx - 1 .. cx + 1), dy = -1, 0, 1, which are the key intervals
    [key + dy W - 1, key + dy W + 1]."""
    w = grid.row_width
    base = query_keys[:, None] + torch.tensor([-w, 0, w], dtype=INDEX,
                                              device=query_keys.device)
    source_keys = source_keys.contiguous()
    starts = torch.searchsorted(source_keys, (base - 1).contiguous(), out_int32=True)
    ends = torch.searchsorted(source_keys, (base + 1).contiguous(), right=True,
                              out_int32=True)
    return starts, ends


def build_neighbor_table(query_positions: torch.Tensor, query_keys: torch.Tensor,
                         source: CellGrid, grid: GridConfig,
                         max_neighbors: int) -> NeighborTable:
    """The fixed-degree table of the queries into a sorted source space: run
    bounds, a (N, 3 window) candidate gather, the distance filter, and the
    compaction of each row's valid candidates into its first K slots."""
    device = query_positions.device
    n = query_positions.shape[0]
    m = source.positions.shape[0]
    k = max_neighbors
    win = grid.window

    if m == 0:  # an empty source space (a scene without boundary particles)
        return NeighborTable(
            idx=torch.zeros((n, k), dtype=INDEX, device=device),
            mask=torch.zeros((n, k), dtype=torch.bool, device=device),
            count=torch.zeros((n,), dtype=INDEX, device=device),
            num_dropped=torch.zeros((), dtype=INDEX, device=device),
        )

    starts, ends = _run_bounds(query_keys, source.keys, grid)  # (N, 3)
    lane = torch.arange(win, dtype=INDEX, device=device)
    cand = starts[:, :, None] + lane  # (N, 3, win)
    in_run = (cand < ends[:, :, None]).reshape(n, 3 * win)
    dropped_window = torch.clamp(ends - starts - win, min=0).sum()
    cand = torch.clamp(cand.reshape(n, 3 * win), 0, m - 1)

    diff = source.positions[cand] - query_positions[:, None, :]  # (N, 3 win, 2)
    dist_sq = (diff * diff).sum(dim=-1)
    valid = (in_run & (dist_sq <= f32_scalar(grid.radius_sq))
             & (dist_sq > f32_scalar(MIN_DISTANCE_SQ)))

    # each valid candidate's slot in its row, in run order (the scan runs over
    # the leading dim of the transpose: CUDA's innermost-dim scan of an
    # (N, 96) tensor took 0.57 ms at 100k, the outer-dim one a column a thread)
    slot = (torch.cumsum(valid.T.contiguous().to(INDEX), dim=0, dtype=INDEX) - 1).T
    count_all = slot[:, -1] + 1
    count = torch.clamp(count_all, max=k)
    dropped_cap = torch.clamp(count_all - k, min=0).sum()

    row = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    target = torch.where(valid & (slot < k), row * k + slot, n * k)  # n * k: cut off
    idx = torch.zeros((n * k + 1,), dtype=INDEX, device=device)
    idx.scatter_(0, target.reshape(-1), cand.reshape(-1))
    mask = torch.arange(k, dtype=INDEX, device=device)[None, :] < count[:, None]
    return NeighborTable(
        idx=idx[:n * k].reshape(n, k),
        mask=mask,
        count=count,
        num_dropped=(dropped_window + dropped_cap).to(INDEX),
    )


def build_neighborhood(sorted_positions: torch.Tensor, sorted_keys: torch.Tensor,
                       boundary: CellGrid, grid: GridConfig) -> Neighborhood:
    """Both tables for already-sorted fluid positions."""
    fluid = CellGrid(positions=sorted_positions, keys=sorted_keys)
    return Neighborhood(
        dynamic=build_neighbor_table(sorted_positions, sorted_keys, fluid, grid,
                                     grid.max_neighbors_dynamic),
        static=build_neighbor_table(sorted_positions, sorted_keys, boundary, grid,
                                    grid.max_neighbors_static),
    )

