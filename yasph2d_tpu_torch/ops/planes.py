"""Plane-form resident layout (the port's counterpart of the plane glue in
yasph2d_tpu/ops/pallas_slotmajor.py: to_planes / from_planes / pf_move_codes).

The solver state lives as planes, slots leading and cells row-major:

    scalar field (P, ny, nx)      vector field (2, P, ny, nx)

The JAX package pads these to (P, NYP, NXP) with NYP a multiple of the TPU row
band and NXP a multiple of the 128-lane vreg, and blocks them into per-band
source windows with skip flags for Mosaic. None of that exists here: a CUDA
thread indexes any (p, y, x) directly and masks the grid edge itself, so the
port keeps the unpadded grid. Dead slots are marked by the mask plane alone.
"""

from typing import NamedTuple

import torch

from ..units import INDEX
from .dense_grid import DenseGridConfig, f32_scalar


class PlaneGeom(NamedTuple):
    """Geometry of one index space (fluid or boundary) in plane form."""

    pos: torch.Tensor  # (2, P, ny, nx) f32
    mask: torch.Tensor  # (P, ny, nx) bool


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


def pf_move_codes(pos: torch.Tensor, mask: torch.Tensor,
                  grid: DenseGridConfig) -> torch.Tensor:
    """(P, ny, nx) uint8 move code per slot: 0 for a dead slot, else
    (dy+1)*3 + (dx+1) + 1 with (dx, dy) the clamped cell offset of the slot's
    position from its current cell. Bit-identical to the JAX pf_move_codes:
    `inv` is the f32 rounding of the double 1/cell_size and the floor runs on
    f32 (pos - origin) * inv."""
    _, ny, nx = mask.shape
    device = pos.device
    inv = f32_scalar(1.0 / grid.cell_size)
    ox, oy = f32_scalar(grid.origin[0]), f32_scalar(grid.origin[1])
    cx = torch.clamp(torch.floor((pos[0] - ox) * inv).to(INDEX), 0, grid.nx - 1)
    cy = torch.clamp(torch.floor((pos[1] - oy) * inv).to(INDEX), 0, grid.ny - 1)
    iy = torch.arange(ny, dtype=INDEX, device=device)[None, :, None]
    ix = torch.arange(nx, dtype=INDEX, device=device)[None, None, :]
    dy = torch.clamp(cy - iy, -1, 1)
    dx = torch.clamp(cx - ix, -1, 1)
    code = (dy + 1) * 3 + (dx + 1) + 1
    return torch.where(mask, code, 0).to(torch.uint8)
