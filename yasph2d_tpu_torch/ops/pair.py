"""Masked fixed-degree pair helpers of the table solvers (PyTorch port of
yasph2d_tpu/ops/pair.py).

A table pass is three steps, as in the JAX package: gather the neighbours'
attributes through the (N, K) index table, per-pair math on (N, K) tiles, a
masked sum over K. A masked slot's gathered data is arbitrary (index 0), so
every per-pair quantity is masked before the sum. The operations are the JAX
helpers' in their order; the sum over K is torch's, so the sums agree with
XLA's to f32 rounding, not bit for bit.
"""

import torch


def gather(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (M, ...) x idx (N, K) -> (N, K, ...). An empty source space
    (M == 0: a scene without boundary) yields zeros: its table is all-masked."""
    if values.shape[0] == 0:
        return torch.zeros(tuple(idx.shape) + tuple(values.shape[1:]), dtype=values.dtype,
                           device=values.device)
    return values[idx]


def pair_geometry(positions: torch.Tensor, neighbor_positions: torch.Tensor):
    """(ri_to_rj, r_sq, r) of each pair: rj - ri (N, K, 2), |.|^2 and |.| (N, K)."""
    ri_to_rj = neighbor_positions - positions[:, None, :]
    r_sq = (ri_to_rj * ri_to_rj).sum(dim=-1)
    return ri_to_rj, r_sq, torch.sqrt(r_sq)


def masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sum per-pair values (N, K, ...) over K, zeroing masked slots."""
    if values.ndim > mask.ndim:
        mask = mask[..., None]
    return torch.where(mask, values, 0.0).sum(dim=1)
