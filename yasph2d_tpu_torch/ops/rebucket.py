"""K2, the per-step neighbourhood rebuild in plane form (PyTorch port of
yasph2d_tpu/ops/pallas_slotmajor.py pf_rebucket, with its pf_move_codes).

Every live slot moves to the cell holding its advected position (clamped into
its old 3x3 window by the move code); each target cell compacts the slots that
arrive, in (dyv, dxv, sp) order, into its slots 0..P-1 and passes their
payload (position + value planes) through exactly. Arrivals beyond P are
dropped and counted. `rebucket` launches csrc/rebucket.cu for CUDA tensors and
runs the plain twin `rebucket_ref` for CPU tensors; both are bit-exact. On the
card the whole re-bucket, move codes, new mask and drop count included, is one
kernel launch after a 4-byte memset; `rebucket_planes` takes the payload as
separate planes, so a caller need not concatenate them first.

Halo form (spatial sharding, parallel/shard_plane.py): with a `planes.Halo`
of the neighbouring shards' rows -1 and ny of (mask, positions, payload),
those rows are source cells too, so a particle that crosses the seam into
this shard's edge row arrives from them, and one that leaves is taken by the
neighbour; every move code (the halo rows' too) is taken against global
rows. Drops are this shard's; the caller sums them over the shards. The JAX
kernel sends the code and payload rows together (pf_rebucket(row0=...)); here
K2 computes the halo rows' codes itself. Launches count under
"rebucket_halo".
"""

from typing import Optional, Sequence

import torch

from ..units import INDEX, REAL
from . import cuda_build
from .dense_grid import DenseGridConfig, f32_scalar
from .planes import Halo, pf_move_codes

# kernel launches, counted where the wrapper launches
LAUNCHES = {"rebucket": 0, "rebucket_halo": 0}

# csrc/rebucket.cu: one thread per target cell of a RB_TY x RB_TX tile
RB_TY, RB_TX = 8, 32
MAX_PAYLOAD = 8  # position x, y and at most six value planes


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(p: int) -> int:
    """Dynamic shared memory of one K2 block: the hit list (P int32 per
    target cell) and the haloed tile's move codes (one byte per slot)."""
    return p * RB_TY * RB_TX * 4 + p * (RB_TY + 2) * (RB_TX + 2)


def check_launch(n_values: int, p: int):
    """Raise unless the kernel takes `n_values` value planes at occupancy
    `p`: at most six planes, and a block's shared memory (`smem_bytes`)
    within the card's."""
    if n_values + 2 > MAX_PAYLOAD:
        raise ValueError(f"rebucket: {n_values} value planes; the kernel takes at "
                         f"most {MAX_PAYLOAD - 2}")
    if smem_bytes(p) > cuda_build.SMEM_LIMIT:
        raise ValueError(f"rebucket: occupancy {p} needs {smem_bytes(p)} bytes of shared "
                         f"memory; a block has {cuda_build.SMEM_LIMIT}")


def rebucket_ref(pos, mask, values, grid: DenseGridConfig, halo: Optional[Halo] = None):
    """Plain PyTorch twin of K2. pos (2, P, ny, nx), mask (P, ny, nx), values
    (D, P, ny, nx); `halo`: rows (mask (P, 2, nx), pos (2, P, 2, nx),
    values (D, P, 2, nx)). Returns (new_pos, new_mask, new_values,
    num_dropped)."""
    p, ny, nx = mask.shape
    src = torch.cat([pos, values], dim=0)  # (n_pay, P, ny, nx)
    if halo is None:
        code = pf_move_codes(pos, mask, grid)
        code_pad = torch.nn.functional.pad(code, (1, 1, 1, 1))
        src_pad = torch.nn.functional.pad(src, (1, 1, 1, 1))
    else:  # rows -1 and ny from the neighbours, codes against global rows
        def rows(a, r):
            return torch.cat([r[..., :1, :], a, r[..., 1:, :]], dim=-2)

        h_mask, h_pos, h_values = halo.planes
        ext_pos = rows(pos, h_pos)
        code = pf_move_codes(ext_pos, rows(mask, h_mask), grid, halo.row0 - 1,
                             halo.ny_total)
        code_pad = torch.nn.functional.pad(code, (1, 1, 0, 0))
        src_pad = torch.nn.functional.pad(
            torch.cat([ext_pos, rows(values, h_values)], dim=0), (1, 1, 0, 0))
    # the 9P candidates of every target cell, in (dyv, dxv, sp) order
    cand_code, cand_pay, expected = [], [], []
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            cand_code.append(code_pad[:, rows, cols])
            cand_pay.append(src_pad[:, :, rows, cols])
            expected.append((2 - dyv) * 3 + (2 - dxv) + 1)
    cand_code = torch.cat(cand_code, dim=0)  # (9P, ny, nx)
    cand_pay = torch.cat(cand_pay, dim=1)  # (n_pay, 9P, ny, nx)
    expected = torch.tensor(expected, dtype=code.dtype, device=code.device)
    sel = cand_code == expected.repeat_interleave(p)[:, None, None]
    rank = torch.cumsum(sel.to(INDEX), dim=0) - 1  # arrival rank per target cell
    total = sel.sum(dim=0, dtype=INDEX)
    # slot k takes the (unique) candidate of rank k; the sum adds only zeros to
    # it, so the payload passes through exactly (-0.0 becomes +0.0, as on the TPU)
    out = torch.stack(
        [torch.where(sel & (rank == k), cand_pay, 0.0).sum(dim=1) for k in range(p)],
        dim=1,
    )
    lane = torch.arange(p, dtype=INDEX, device=total.device)[:, None, None]
    num_dropped = torch.clamp(total - p, min=0).sum().to(INDEX)
    return out[0:2], lane < total[None], out[2:], num_dropped


def _split(stacked: torch.Tensor, parts: Sequence[torch.Tensor]) -> tuple:
    """Views of the (D, P, ny, nx) re-bucketed payload in the shapes of
    `parts`: a (P, ny, nx) part takes one plane, a (L, P, ny, nx) part L."""
    out, k = [], 0
    for part in parts:
        if part.ndim == 3:
            out.append(stacked[k])
            k += 1
        else:
            out.append(stacked[k:k + part.shape[0]])
            k += part.shape[0]
    return tuple(out)


def _stack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([v if v.ndim == 4 else v[None] for v in parts], dim=0)


def rebucket_planes(pos, mask, payload: Sequence[torch.Tensor], grid: DenseGridConfig,
                    halo: Optional[Halo] = None):
    """Windowed re-bucket of the plane-form state with the payload given as
    separate (P, ny, nx) or (L, P, ny, nx) planes. Returns (new_pos, new_mask,
    the new payload parts in the input's shapes, num_dropped); dispatches on
    device. The CPU route concatenates the parts for `rebucket_ref`; the CUDA
    route passes one pointer per plane and copies nothing. `halo`: the
    neighbours' rows of (mask, pos, *payload) as `Halo.planes` (module
    docstring)."""
    device = pos.device
    if device.type == "cpu":
        if halo is not None:
            h_mask, h_pos, *h_payload = halo.planes
            halo = halo._replace(planes=(h_mask, h_pos, _stack(h_payload)))
        new_pos, new_mask, new_values, drops = rebucket_ref(pos, mask, _stack(payload), grid,
                                                            halo)
        return new_pos, new_mask, _split(new_values, payload), drops
    if device.type != "cuda":
        raise ValueError(f"rebucket: unsupported device {device}")
    p, ny, nx = mask.shape
    cuda_build.check_tensor(pos, device, (2, p, ny, nx), REAL, "rebucket: positions")
    cuda_build.check_tensor(mask, device, (p, ny, nx), torch.bool, "rebucket: mask")
    ptrs = cuda_build.plane_pointers([pos, *payload], device, p, ny, nx, "rebucket: payload")
    check_launch(len(ptrs) - 2, p)
    out = torch.empty((len(ptrs), p, ny, nx), dtype=REAL, device=device)
    new_mask = torch.empty((p, ny, nx), dtype=torch.bool, device=device)
    dropped = torch.empty((), dtype=INDEX, device=device)
    lib, stream = cuda_build.library(), torch.cuda.current_stream(device).cuda_stream
    move = (f32_scalar(1.0 / grid.cell_size), f32_scalar(grid.origin[0]),
            f32_scalar(grid.origin[1]))
    if halo is None:
        name = "rebucket"
        err = lib.rebucket(
            mask.data_ptr(), cuda_build.pointer_array(ptrs), len(ptrs), out.data_ptr(),
            new_mask.data_ptr(), dropped.data_ptr(), p, ny, nx, grid.nx, grid.ny, *move,
            stream,
        )
    else:
        name = "rebucket_halo"
        h_mask, *h_rows = halo.planes
        cuda_build.check_tensor(h_mask, device, (p, 2, nx), torch.bool, "rebucket: halo mask")
        h_ptrs = cuda_build.plane_pointers(h_rows, device, p, 2, nx, "rebucket: halo payload")
        if len(h_ptrs) != len(ptrs):
            raise ValueError(f"rebucket: {len(h_ptrs)} halo payload planes for {len(ptrs)}")
        err = lib.rebucket_halo(
            mask.data_ptr(), cuda_build.pointer_array(ptrs), len(ptrs), out.data_ptr(),
            new_mask.data_ptr(), dropped.data_ptr(), p, ny, nx, grid.nx, halo.ny_total,
            *move, h_mask.data_ptr(), cuda_build.pointer_array(h_ptrs), halo.row0, stream,
        )
    cuda_build.check(err, name)
    LAUNCHES[name] += 1
    return out[0:2], new_mask, _split(out[2:], payload), dropped


def rebucket(pos, mask, values, grid: DenseGridConfig, halo: Optional[Halo] = None):
    """Windowed re-bucket of the plane-form state; values (D, P, ny, nx).
    Returns (new_pos, new_mask, new_values, num_dropped); dispatches on
    device. `halo` as `rebucket_planes` takes it."""
    new_pos, new_mask, (new_values,), drops = rebucket_planes(pos, mask, (values,), grid,
                                                              halo)
    return new_pos, new_mask, new_values, drops
