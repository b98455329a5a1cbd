"""Plane-form resident layout (the port's counterpart of the plane glue in
yasph2d_tpu/ops/pallas_slotmajor.py: to_planes / from_planes / pf_move_codes).

The solver state lives as planes, slots leading and cells row-major:

    scalar field (P, ny, nx)      vector field (2, P, ny, nx)

The JAX package pads these to (P, NYP, NXP) with NYP a multiple of the TPU row
band and NXP a multiple of the 128-lane vreg, and blocks them into per-band
source windows with skip flags for Mosaic. None of that exists here: a CUDA
thread indexes any (p, y, x) directly and masks the grid edge itself, so the
port keeps the unpadded grid. Dead slots are marked by the mask plane alone.

Under spatial sharding (parallel/shard_plane.py) each process holds a band of
cell rows, and rows -1 and ny of its planes come from the neighbouring shards
as a `Halo`: the pair kernel K1 reads them as source cells, the re-bucket K2
as the cells that particles migrate from. Cells are then numbered by global
row: the bf16 rebase centres and the move codes take the shard's `row0`.
"""

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..units import INDEX, REAL
from .dense_grid import DenseGridConfig, f32_scalar


class Halo(NamedTuple):
    """Rows -1 and ny of a shard's planes, received from the neighbouring
    shards: each plane's two rows stacked as (..., 2, nx), row -1 (the
    previous shard's last row) at index 0 and row ny (the next shard's first
    row) at index 1. At the ends of the mesh a row is dead: mask False, zero
    values. `row0` is the shard's first global cell row, `ny_total` the
    global row count."""

    planes: Tuple[torch.Tensor, ...]
    row0: int
    ny_total: int


class PlaneGeom(NamedTuple):
    """Geometry of one index space (fluid or boundary) in plane form, as the
    pair kernel K1 reads it. In float32 mode `pos` is the carry's position
    planes themselves; in bfloat16 mode (`plane_geom`) it is a bf16 copy
    rebased onto each cell's centre and `rebase_cell` is the cell size it
    was built with. Under sharding `halo` holds the neighbours' rows of
    (pos, mask), exchanged once per build; K1 then reads them as source
    rows -1 and ny instead of dead cells."""

    pos: torch.Tensor  # (2, P, ny, nx) f32, or bf16 cell-relative
    mask: torch.Tensor  # (P, ny, nx) bool
    rebase_cell: Optional[float] = None  # None: absolute f32 positions
    halo: Optional[Halo] = None  # planes (pos (2, P, 2, nx), mask (P, 2, nx))


@functools.lru_cache(maxsize=8)
def _cell_centres(grid: DenseGridConfig, device: torch.device, row0: int) -> torch.Tensor:
    """(2, 1, ny, nx) f32 centre of every cell, built once per grid, device
    and row offset: (i + 0.5 + row0) * f32(h) + f32(origin) with i the
    global cell row under sharding, each operation in f32 as the JAX
    `_pf_rebase` computes it (so both shards of a seam see the same
    centres; row0 = 0 adds an exact zero)."""
    h = f32_scalar(grid.cell_size)
    cx = (torch.arange(grid.nx, dtype=REAL, device=device) + 0.5) * h \
        + f32_scalar(grid.origin[0])
    cy = (torch.arange(grid.ny, dtype=REAL, device=device) + 0.5 + row0) * h \
        + f32_scalar(grid.origin[1])
    shape = (grid.ny, grid.nx)
    return torch.stack([cx.expand(shape), cy[:, None].expand(shape)])[:, None]


def plane_geom(pos: torch.Tensor, mask: torch.Tensor, grid: DenseGridConfig,
               row0: int = 0) -> PlaneGeom:
    """K1's geometry of one index space under `grid.pair_dtype`, built once
    per rebuild (the port's `pf_build_geom`): the planes themselves in
    float32; in bfloat16 the positions relative to their own cell's centre
    (values in [-h/2, h/2] survive the cast, absolute coordinates would not),
    one f32 subtract and a round-to-nearest-even cast: JAX's `_pf_rebase`
    and astype, bit for bit. Dead slots stay marked by the mask alone.
    `row0`: the shard's first global cell row (0 on one device)."""
    if grid.pair_dtype == "float32":
        return PlaneGeom(pos, mask)
    rebased = pos - _cell_centres(grid, pos.device, row0)
    return PlaneGeom(rebased.to(grid.pair_torch_dtype), mask, float(grid.cell_size))


def to_planes(a: torch.Tensor) -> torch.Tensor:
    """(ny, nx, P[, 2]) slot array -> (P, ny, nx) / (2, P, ny, nx), contiguous."""
    if a.ndim == 3:
        return a.permute(2, 0, 1).contiguous()
    return a.permute(3, 2, 0, 1).contiguous()


def from_planes(p: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_planes`: (P, ny, nx) -> (ny, nx, P); (2, P, ny, nx) ->
    (ny, nx, P, 2)."""
    if p.ndim == 3:
        return p.permute(1, 2, 0)
    return p.permute(2, 3, 1, 0)


def pf_move_codes(pos: torch.Tensor, mask: torch.Tensor, grid: DenseGridConfig,
                  row0: int = 0, ny_total: Optional[int] = None) -> torch.Tensor:
    """(P, ny, nx) uint8 move code per slot: 0 for a dead slot, else
    (dy+1)*3 + (dx+1) + 1 with (dx, dy) the clamped cell offset of the slot's
    position from its current cell. Bit-identical to the JAX pf_move_codes:
    `inv` is the f32 rounding of the double 1/cell_size and the floor runs on
    f32 (pos - origin) * inv. Under sharding the rows are global: plane row
    i is cell row `row0` + i and cell rows clamp to `ny_total` (default
    grid.ny), so that a move across the seam survives."""
    _, ny, nx = mask.shape
    device = pos.device
    ny_total = grid.ny if ny_total is None else ny_total
    inv = f32_scalar(1.0 / grid.cell_size)
    ox, oy = f32_scalar(grid.origin[0]), f32_scalar(grid.origin[1])
    cx = torch.clamp(torch.floor((pos[0] - ox) * inv).to(INDEX), 0, grid.nx - 1)
    cy = torch.clamp(torch.floor((pos[1] - oy) * inv).to(INDEX), 0, ny_total - 1)
    iy = torch.arange(row0, row0 + ny, dtype=INDEX, device=device)[None, :, None]
    ix = torch.arange(nx, dtype=INDEX, device=device)[None, None, :]
    dy = torch.clamp(cy - iy, -1, 1)
    dx = torch.clamp(cx - ix, -1, 1)
    code = (dy + 1) * 3 + (dx + 1) + 1
    return torch.where(mask, code, 0).to(torch.uint8)
