"""Dense slot grid (PyTorch port of yasph2d_tpu/ops/dense_grid.py): the init-time
slot build and the re-bucket's move codes.

Particles are sorted by row-major cell key and laid out in a dense (ny, nx, P)
slot grid (P = max occupancy per cell).

`DenseGridConfig.use_pallas_slotmajor` (the JAX field, with its default False)
picks the pair kernel of the padded solvers: True runs their pair passes on
K3 (ops/sm_pair_reduce.py), False on K5 (ops/pallas_pair.py); both rebuild
on K4 (ops/sm_rebucket.py). The plane solvers require True, as the JAX ones
do. The JAX package has two routes for False, the XLA `pair_reduce` and the
gen-1 Pallas kernel behind `use_pallas`; they compute one contract, so here
both are the one K5 route and the `use_pallas` flag is not ported (it would
be a knob without effect). `pair_dtype` ("float32" or "bfloat16") is the
JAX field: the plane solvers take "bfloat16" as K1's bf16 operands, the
padded solvers on the K5 route as K5's bf16 math mode (the JAX XLA
`pair_reduce`'s), and K3 refuses it, as JAX does. The slot build makes the
initial carry and the static boundary index space, and the sorted
carries (models/dfsph_dense.DFSPHDenseSolver, models/wcsph_dense.
WCSPHDenseSolver) rebuild with it every step, converting between the sorted
and the padded layout with `pad_to_slots` and `slots_to_sorted`; the padded
and plane carries' per-step rebuild is the windowed re-bucket
(ops/rebucket.py in plane form, ops/sm_rebucket.py in this slot layout),
which takes its move codes from `move_codes`.

The DFSPH solvers' loop-gradient variants (`cache_loop_gradients`,
`mxu_loop_gradients`, models/dfsph_dense.py) run on three plain tensor
functions here, as in the JAX package, where they are XLA and no Pallas
kernel: `neighbor_windows` (the 3 x 3 cell views as one candidate axis),
`pair_map` (a per-pair map, invalid pairs exact zeros) and
`cached_pair_reduce` (a sum over the candidate axis of a cached map).

The slot build is bit-for-bit the JAX package's: same f32 cell-coordinate
arithmetic, a stable sort (jax.lax.sort is stable, so ties keep input order),
same clamped slot indices, same overflow accounting.
"""

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..units import INDEX

MIN_DISTANCE_SQ = 1.0e-10  # self/degenerate filter (reference: neighborhood_search.rs:324)
PAIR_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DenseGridConfig:
    """Static dense-grid configuration: the grid covers [origin, origin + (nx, ny)
    * cell_size), with cell_size == search radius == smoothing length
    (neighborhood_search.rs:461-479)."""

    cell_size: float
    origin: tuple  # (x0, y0)
    nx: int
    ny: int
    occupancy: int = 8  # P: max particles per cell
    use_pallas_slotmajor: bool = False  # padded solvers: K3 if True, else K5
    # "float32" (exact) or "bfloat16". The plane solvers' K1: positions rebased
    # onto their cell centre and stored in bf16, value operands rounded to
    # bf16, all math and accumulation in f32 (ops/planes.plane_geom,
    # ops/pair_reduce.py). The padded solvers' K5: cell-relative positions and
    # per-pair math in bf16, sums in f32 (ops/pallas_pair.py). K3 takes
    # float32 only.
    pair_dtype: str = "float32"

    def __post_init__(self):
        if self.pair_dtype not in PAIR_DTYPES:
            raise ValueError(f"pair_dtype must be one of {tuple(PAIR_DTYPES)}, "
                             f"got {self.pair_dtype!r}")

    @property
    def pair_torch_dtype(self) -> torch.dtype:
        return PAIR_DTYPES[self.pair_dtype]

    @property
    def radius_sq(self) -> float:
        return self.cell_size * self.cell_size

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny


def require_float32_pairs(grid: DenseGridConfig, solver: str):
    """The padded solvers' slot-major kernel K3 takes float32 operands only:
    raise for a bfloat16 grid on that route, as the JAX padded solvers
    assert. Their K5 route takes bfloat16 as its bf16 math mode, the JAX XLA
    route's (yasph2d_tpu/ops/dense_grid.py pair_reduce `relative`;
    ops/pallas_pair.py)."""
    if grid.pair_dtype != "float32" and grid.use_pallas_slotmajor:
        raise ValueError(
            f"{solver}: the slot-major pair kernel K3 computes on float32 planes; "
            "bfloat16 operands need the plane solvers (DFSPHPlaneSolver, "
            "WCSPHPlaneSolver) or the K5 route (use_pallas_slotmajor=False)")


def f32_scalar(x) -> float:
    """The f32 rounding of a double as a Python float. An f32 tensor op with
    it computes in f32, as with a 0-d f32 tensor, and makes no host-to-device
    copy, so the glue around the kernels can be captured in a CUDA graph."""
    return float(np.float32(x))


def cell_coords(positions: torch.Tensor, grid: DenseGridConfig):
    """(cx, cy) int32 cell coordinates, clamped into the grid. `inv` is the f32
    rounding of the double 1/cell_size, as in the JAX package."""
    inv = f32_scalar(1.0 / grid.cell_size)
    cx = torch.floor((positions[..., 0] - f32_scalar(grid.origin[0])) * inv).to(INDEX)
    cy = torch.floor((positions[..., 1] - f32_scalar(grid.origin[1])) * inv).to(INDEX)
    return torch.clamp(cx, 0, grid.nx - 1), torch.clamp(cy, 0, grid.ny - 1)


def cell_keys(positions: torch.Tensor, grid: DenseGridConfig, alive=None,
              row0: int = 0, ny_total: int = None):
    """Row-major cell key per particle; dead particles get the sentinel key
    `num_cells`, which sorts after every real cell and never enters the grid.
    Under sharding `grid` is the shard's band of rows from global row `row0`
    of `ny_total`: rows are taken against the global origin, clamped to the
    global rows, then to the shard's (the JAX `_SpatialCollectives._sort`);
    a particle outside the band lands in its edge row."""
    if ny_total is None:
        cx, cy = cell_coords(positions, grid)
    else:
        cx, cy = cell_coords(positions, dataclasses.replace(grid, ny=ny_total))
        cy = torch.clamp(cy - row0, 0, grid.ny - 1)
    keys = cy * grid.nx + cx
    if alive is not None:
        keys = torch.where(alive, keys, torch.full_like(keys, grid.num_cells))
    return keys


class SlotGrid(NamedTuple):
    """Dense slot layout of one sorted index space (see the JAX twin)."""

    slot_idx: torch.Tensor  # (C, P) int32 into sorted arrays (clamped where masked)
    slot_mask: torch.Tensor  # (C, P) bool
    inverse: torch.Tensor  # (N,) int32 into flat (C*P,) slot order
    in_grid: torch.Tensor  # (N,) bool: particle kept (rank < P)
    num_dropped: torch.Tensor  # () int32


def build_slot_grid(sorted_keys: torch.Tensor, grid: DenseGridConfig) -> SlotGrid:
    """Dense slot layout from sorted cell keys: cell starts are the exclusive
    cumsum of per-cell counts, and a cell's slots are `start + lane`."""
    device = sorted_keys.device
    n = sorted_keys.shape[0]
    p = grid.occupancy
    c = grid.num_cells
    if n == 0:
        return SlotGrid(
            slot_idx=torch.zeros((c, p), dtype=INDEX, device=device),
            slot_mask=torch.zeros((c, p), dtype=torch.bool, device=device),
            inverse=torch.zeros((0,), dtype=INDEX, device=device),
            in_grid=torch.zeros((0,), dtype=torch.bool, device=device),
            num_dropped=torch.zeros((), dtype=INDEX, device=device),
        )
    keys = sorted_keys.long()
    # keys >= C are the dead-particle sentinel: excluded from the counts
    counts = torch.bincount(keys[keys < c], minlength=c)[:c]
    starts = torch.cumsum(counts, 0) - counts

    lane = torch.arange(p, device=device)
    slot_idx = torch.clamp(starts[:, None] + lane[None, :], 0, n - 1)
    slot_mask = lane[None, :] < torch.clamp(counts, max=p)[:, None]

    rank = torch.arange(n, device=device) - starts[torch.clamp(keys, max=c - 1)]
    in_grid = (rank < p) & (keys < c)
    inverse = torch.clamp(keys * p + torch.clamp(rank, max=p - 1), 0, c * p - 1)
    num_dropped = torch.clamp(counts - p, min=0).sum()
    return SlotGrid(
        slot_idx=slot_idx.to(INDEX),
        slot_mask=slot_mask,
        inverse=inverse.to(INDEX),
        in_grid=in_grid,
        num_dropped=num_dropped.to(INDEX),
    )


def sort_by_dense_keys(tensors, positions: torch.Tensor, grid: DenseGridConfig,
                       alive=None, row0: int = 0, ny_total: int = None):
    """Sort a tuple of per-particle tensors into dense cell-key order (stable, so
    the order matches jax.lax.sort's). Returns (sorted_tensors, sorted_keys).
    `row0`, `ny_total`: a shard's band of rows, as `cell_keys` takes them."""
    keys = cell_keys(positions, grid, alive, row0, ny_total)
    sorted_keys, perm = torch.sort(keys, stable=True)
    return tuple(t[perm] for t in tensors), sorted_keys


def pad_to_slots(values: torch.Tensor, slots: SlotGrid, grid: DenseGridConfig):
    """Sorted per-particle values (N, ...) -> padded (ny, nx, P, ...); masked slots
    hold the value at a clamped index (callers must mask). An empty index space
    yields zeros."""
    shape = (grid.ny, grid.nx, grid.occupancy) + tuple(values.shape[1:])
    if values.shape[0] == 0:
        return torch.zeros(shape, dtype=values.dtype, device=values.device)
    return values[slots.slot_idx.long()].reshape(shape)


def slots_to_sorted(padded: torch.Tensor, slots: SlotGrid, grid: DenseGridConfig,
                    fallback=0.0) -> torch.Tensor:
    """Padded (ny, nx, P, ...) -> sorted per-particle (N, ...). A particle
    with no slot (cell overflow, or dead) gets `fallback` (a per-particle
    tensor or a scalar), never another particle's value."""
    flat = padded.reshape((grid.num_cells * grid.occupancy,) + tuple(padded.shape[3:]))
    gathered = flat[slots.inverse]
    in_grid = slots.in_grid.reshape((-1,) + (1,) * (gathered.ndim - 1))
    return torch.where(in_grid, gathered, fallback)


def move_codes(positions_pad: torch.Tensor, mask: torch.Tensor,
               grid: DenseGridConfig, row0: int = 0, ny_total: int = None) -> torch.Tensor:
    """(ny, nx, P) uint8 move code per slot, in the OLD slot layout: 0 for a
    dead slot, else (dy+1)*3 + (dx+1) + 1 with (dx, dy) the clamped offset of
    the cell holding the slot's (advected) position from the slot's own cell.
    Bit-identical to the JAX move_codes. Under sharding (JAX `row0`) the rows
    are global: row i is cell row `row0` + i and cell rows clamp to
    `ny_total` (default grid.ny), so that a move across the seam survives."""
    ny, nx, _ = mask.shape
    device = positions_pad.device
    iy = torch.arange(row0, row0 + ny, dtype=INDEX, device=device)[:, None, None]
    ix = torch.arange(nx, dtype=INDEX, device=device)[None, :, None]
    cx, cy = cell_coords(positions_pad, grid if ny_total is None
                         else dataclasses.replace(grid, ny=ny_total))
    dy = torch.clamp(cy - iy, -1, 1)
    dx = torch.clamp(cx - ix, -1, 1)
    code = (dy + 1) * 3 + (dx + 1) + 1
    return torch.where(mask, code, 0).to(torch.uint8)


def neighbor_windows(padded: torch.Tensor) -> torch.Tensor:
    """(ny, nx, P, ...) -> (ny, nx, 9P, ...): each cell's candidates, the slots
    of its 3 x 3 cells in (dy, dx) order, zero rows and columns at the border
    (the JAX function; under sharding too: no halo)."""
    ny, nx = padded.shape[:2]
    full = padded.new_zeros((ny + 2, nx + 2) + tuple(padded.shape[2:]))
    full[1:-1, 1:-1] = padded
    return torch.cat([full[dy:dy + ny, dx:dx + nx] for dy in range(3) for dx in range(3)],
                     dim=2)


def pair_map(fn, query_pos: torch.Tensor, query_mask: torch.Tensor,
             source_pos: torch.Tensor, source_mask: torch.Tensor, grid: DenseGridConfig):
    """fn(ri_to_rj, r_sq, r) on every (query, candidate) pair, without a sum:
    each output leaf (a tensor or a tuple of them) is (ny, nx, P, 9Ps[, D]),
    zero where the pair is invalid (a dead slot, out of the radius, or the
    particle itself: r_sq <= radius_sq and r_sq > MIN_DISTANCE_SQ, as in JAX).
    9Ps times the slot count: the caller owns the memory."""
    cand_pos = neighbor_windows(source_pos)
    cand_mask = neighbor_windows(source_mask)
    ri_to_rj = cand_pos[:, :, None, :, :] - query_pos[:, :, :, None, :]
    r_sq = (ri_to_rj * ri_to_rj).sum(dim=-1)
    valid = (query_mask[:, :, :, None] & cand_mask[:, :, None, :]
             & (r_sq <= f32_scalar(grid.radius_sq)) & (r_sq > f32_scalar(MIN_DISTANCE_SQ)))
    out = fn(ri_to_rj, r_sq, torch.sqrt(r_sq))

    def mask_leaf(leaf):
        m = valid if leaf.ndim == valid.ndim else valid[..., None]
        return torch.where(m, leaf, torch.zeros((), dtype=leaf.dtype, device=leaf.device))

    return tuple(mask_leaf(t) for t in out) if isinstance(out, tuple) else mask_leaf(out)


def cached_pair_reduce(fn, cache, source_values=(), query_values=()):
    """The sum over the candidate axis of fn(cache, *query values, *candidate
    values): candidates arrive windowed as (ny, nx, 1, 9Ps[, D]), queries as
    (ny, nx, P, 1[, D]). The cache (pair_map's) is zero on invalid pairs, so
    each term of fn must be proportional to it (the JAX contract)."""
    cand = [neighbor_windows(v)[:, :, None] for v in source_values]
    q = [v[:, :, :, None] if v.ndim == 3 else v[:, :, :, None, :] for v in query_values]
    out = fn(cache, *q, *cand)
    return tuple(t.sum(dim=3) for t in out) if isinstance(out, tuple) else out.sum(dim=3)
