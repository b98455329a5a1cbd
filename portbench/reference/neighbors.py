"""Neighbour pairs of the reference: a cell-sorted particle list.

Sources are sorted by the row-major key of their cell (size h); a query
takes, in each of its 3 x 3 cells, that cell's run of sources, padded to
the fullest cell's count. A pair counts where 1e-10 < |x_j - x_i|^2 <= h^2
(the upstream neighbourhood rule, neighborhood_search.rs:324). The table
keeps, per query and candidate, the source index, the offset
x_j - x_i, r^2, r and whether the pair counts.
"""

from typing import NamedTuple

import torch

MIN_DISTANCE_SQ = 1.0e-10


class Pairs(NamedTuple):
    idx: torch.Tensor  # (N, C) int64 source index (0 where not valid)
    valid: torch.Tensor  # (N, C) bool
    dx: torch.Tensor  # (N, C) x_j - x_i
    dy: torch.Tensor  # (N, C) y_j - y_i
    r_sq: torch.Tensor  # (N, C)
    r: torch.Tensor  # (N, C)

    def gather(self, values: torch.Tensor) -> torch.Tensor:
        """`values` (M[, ...]) of each pair's source, (N, C[, ...])."""
        return values[self.idx]

    def sum(self, term: torch.Tensor) -> torch.Tensor:
        """Sum over each query's valid pairs of `term` (N, C)."""
        return torch.where(self.valid, term, 0.0).sum(dim=1)


def cells(x: torch.Tensor, k):
    """(cx, cy) int64 cell of each position, clamped into the grid."""
    cx = torch.floor((x[:, 0] - k.origin[0]) / k.h).long().clamp(0, k.nx - 1)
    cy = torch.floor((x[:, 1] - k.origin[1]) / k.h).long().clamp(0, k.ny - 1)
    return cx, cy


def pairs(query: torch.Tensor, source: torch.Tensor, k) -> Pairs:
    """The pair table of `query` (N, 2) against `source` (M, 2) on the grid
    of `k` (reference.Consts)."""
    device = query.device
    n_cells = k.nx * k.ny
    sx, sy = cells(source, k)
    keys = sy * k.nx + sx
    order = torch.argsort(keys, stable=True)
    counts = torch.bincount(keys, minlength=n_cells)
    starts = torch.cumsum(counts, 0) - counts
    width = int(counts.max()) if source.shape[0] else 0
    qx, qy = cells(query, k)
    lane = torch.arange(width, device=device)
    idx, ok = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cx, cy = qx + dx, qy + dy
            inside = (cx >= 0) & (cx < k.nx) & (cy >= 0) & (cy < k.ny)
            cell = torch.where(inside, cy * k.nx + cx, 0)
            n = torch.where(inside, counts[cell], 0)
            ok.append(lane[None, :] < n[:, None])
            pos = (starts[cell][:, None] + lane[None, :]).clamp(max=max(source.shape[0] - 1, 0))
            idx.append(order[pos])
    idx = torch.cat(idx, dim=1)
    ok = torch.cat(ok, dim=1)
    d = source[idx] - query[:, None, :]
    dx, dy = d[..., 0], d[..., 1]
    r_sq = dx * dx + dy * dy
    valid = ok & (r_sq > MIN_DISTANCE_SQ) & (r_sq <= k.h * k.h)
    return Pairs(idx=torch.where(valid, idx, 0), valid=valid, dx=dx, dy=dy, r_sq=r_sq,
                 r=torch.sqrt(r_sq))
