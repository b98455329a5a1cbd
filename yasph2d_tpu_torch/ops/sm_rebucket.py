"""K4, the per-step neighbourhood rebuild in the padded slot-major layout
(PyTorch port of yasph2d_tpu/ops/pallas_slotmajor.py sm_rebucket, with its
move codes).

The same re-bucket as K2 (ops/rebucket.py), on the solver carry's own layout:
every live slot moves to the cell holding its advected position (clamped into
its old 3x3 window by the move code); each target cell compacts the slots that
arrive, in (dyv, dxv, sp) order, into its slots 0..P-1 and passes their
position and values through exactly. Arrivals beyond P are dropped and
counted. `sm_rebucket` and `sm_rebucket_parts` launch csrc/sm_rebucket.cu for
CUDA tensors and run the plain twin `sm_rebucket_ref` for CPU tensors; both
are bit-exact. On the card the whole re-bucket, move codes, new mask and drop
count included, is one kernel launch after a 4-byte memset;
`sm_rebucket_parts` takes the payload as separate parts, so a caller need not
concatenate them first.

Halo form (spatial sharding, parallel/shard_dense.py): with a `planes.Halo`
of the neighbouring shards' rows -1 and ny of (mask (2, nx, P), positions
(2, nx, P, 2), then each payload part (2, nx, P[, C]); row -1 at index 0,
dead at the ends of the mesh), those rows are source cells too: a slot that
crosses the seam into this shard's edge row arrives from them, and one that
leaves is taken by the neighbour. Every move code, the halo rows' too, is
taken against global rows (`Halo.row0`, `Halo.ny_total`). The drops are
this shard's; the caller sums them over the shards. This is the JAX
package's XLA `dense_grid.rebucket(row0=...)`, which its sharded padded
route runs; K4 computes the halo rows' codes itself instead of receiving
them. The launches count under "sm_rebucket_halo". The kernel runs the
one-device path on every tile that does not reach the halo rows.

The kernel numbers slots in 32 bits; a grid past that (`index_fits`) raises.
"""

from typing import Optional, Sequence

import torch

from ..units import INDEX, REAL
from ..utils.profiling import scope
from . import cuda_build
from .dense_grid import DenseGridConfig, f32_scalar, move_codes
from .planes import Halo

# kernel launches, counted where the wrapper launches
LAUNCHES = {"sm_rebucket": 0, "sm_rebucket_halo": 0}

MAX_PARTS = 8  # csrc/sm_rebucket.cu SR_MAX_PARTS
# above this occupancy the kernel's words no longer fit one block's shared
# memory and it scans in device memory, one thread per target cell
STAGED_MAX_P = 32 * 18
# the kernel numbers slots in 32 bits: (ny + 2) nx P times the widest part
# (at least 2, the positions' float2) must not pass this
MAX_INDEX = 2**31 - 1


def index_fits(ny: int, nx: int, p: int, widths: Sequence[int]) -> bool:
    """Whether K4's 32-bit slot indices cover a grid of (ny, nx, P) slots, two
    halo rows and payload parts of `widths` components (the launcher's test)."""
    return (ny + 2) * nx * p * max(2, *widths) <= MAX_INDEX


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sm_rebucket_ref(pos, mask, values, grid: DenseGridConfig, halo: Optional[Halo] = None):
    """Plain PyTorch twin of K4. pos (ny, nx, P, 2), mask (ny, nx, P), values
    (ny, nx, P, D); `halo`: rows (mask (2, nx, P), pos (2, nx, P, 2), values
    (2, nx, P, D)). Returns (new_pos, new_mask, new_values, num_dropped)."""
    ny, nx, p = mask.shape
    if halo is None:
        code = move_codes(pos, mask, grid)
        src = torch.cat([pos, values], dim=-1)  # (ny, nx, P, 2 + D)
        code_pad = torch.nn.functional.pad(code, (0, 0, 1, 1, 1, 1))
        src_pad = torch.nn.functional.pad(src, (0, 0, 0, 0, 1, 1, 1, 1))
    else:  # rows -1 and ny from the neighbours, codes against global rows
        def rows(a, r):
            return torch.cat([r[:1], a, r[1:]])

        h_mask, h_pos, h_values = halo.planes
        ext_pos = rows(pos, h_pos)
        code = move_codes(ext_pos, rows(mask, h_mask), grid, halo.row0 - 1, halo.ny_total)
        code_pad = torch.nn.functional.pad(code, (0, 0, 1, 1))
        src_pad = torch.nn.functional.pad(torch.cat([ext_pos, rows(values, h_values)], dim=-1),
                                          (0, 0, 0, 0, 1, 1))
    # the 9P candidates of every target cell, in (dyv, dxv, sp) order
    cand_code, cand_pay, expected = [], [], []
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            cand_code.append(code_pad[rows, cols])
            cand_pay.append(src_pad[rows, cols])
            expected.append((2 - dyv) * 3 + (2 - dxv) + 1)
    cand_code = torch.cat(cand_code, dim=2)  # (ny, nx, 9P)
    cand_pay = torch.cat(cand_pay, dim=2)  # (ny, nx, 9P, 2 + D)
    expected = torch.tensor(expected, dtype=code.dtype, device=code.device)
    sel = cand_code == expected.repeat_interleave(p)
    rank = torch.cumsum(sel.to(INDEX), dim=2) - 1  # arrival rank per target cell
    total = sel.sum(dim=2, dtype=INDEX)
    # slot k takes the (unique) candidate of rank k; the sum adds only zeros to
    # it, so the payload passes through exactly (-0.0 becomes +0.0, as on the TPU)
    out = torch.stack(
        [torch.where((sel & (rank == k))[..., None], cand_pay, 0.0).sum(dim=2)
         for k in range(p)],
        dim=2,
    )
    lane = torch.arange(p, dtype=INDEX, device=total.device)
    num_dropped = torch.clamp(total - p, min=0).sum().to(INDEX)
    return out[..., :2], lane < total[..., None], out[..., 2:], num_dropped


def _split(stacked: torch.Tensor, parts: Sequence[torch.Tensor]) -> tuple:
    """The (ny, nx, P, D) re-bucketed payload cut into tensors of the parts'
    shapes: an (ny, nx, P) part takes one component, an (ny, nx, P, C) part C."""
    out, k = [], 0
    for part in parts:
        c = 1 if part.ndim == 3 else part.shape[-1]
        piece = stacked[..., k:k + c]
        out.append((piece[..., 0] if part.ndim == 3 else piece).contiguous())
        k += c
    return tuple(out)


def _stack(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([v[..., None] if v.ndim == 3 else v for v in parts], dim=-1)


def sm_rebucket_parts(pos, mask, parts: Sequence[torch.Tensor], grid: DenseGridConfig,
                      halo: Optional[Halo] = None):
    """Windowed re-bucket of the padded slot-major state with the payload given
    as parts, each (ny, nx, P) or (ny, nx, P, C). Returns (new_pos, new_mask,
    the new parts in the input's shapes, num_dropped); dispatches on device.
    The CPU route concatenates the parts for `sm_rebucket_ref`; the CUDA route
    passes one pointer per part and copies nothing. `halo`: the neighbours'
    rows of (mask, pos, *parts) as `Halo.planes` (module docstring). Runs in
    the profiler scope "K4.rebucket" (utils/profiling.py), which every
    padded route's re-bucket shares."""
    with scope("K4", "rebucket"):
        return _rebucket_parts(pos, mask, parts, grid, halo)


def _rebucket_parts(pos, mask, parts, grid, halo):
    if not parts:
        raise ValueError("sm_rebucket: the payload needs at least one part")
    device = pos.device
    if halo is not None and len(halo.planes) != 2 + len(parts):
        raise ValueError(f"sm_rebucket: {len(halo.planes) - 2} halo payload parts for "
                         f"{len(parts)}")
    if device.type == "cpu":
        if halo is not None:
            h_mask, h_pos, *h_parts = halo.planes
            halo = halo._replace(planes=(h_mask, h_pos, _stack(h_parts)))
        new_pos, new_mask, new_values, drops = sm_rebucket_ref(pos, mask, _stack(parts), grid,
                                                               halo)
        return new_pos, new_mask, _split(new_values, parts), drops
    if device.type != "cuda":
        raise ValueError(f"sm_rebucket: unsupported device {device}")
    ny, nx, p = mask.shape
    cuda_build.check_tensor(pos, device, (ny, nx, p, 2), REAL, "sm_rebucket: positions")
    cuda_build.check_tensor(mask, device, (ny, nx, p), torch.bool, "sm_rebucket: mask")
    if pos.data_ptr() % 8:
        raise ValueError("sm_rebucket: positions must be 8-byte aligned (float2)")
    if len(parts) > MAX_PARTS:
        raise ValueError(f"sm_rebucket: {len(parts)} payload parts; the kernel takes at "
                         f"most {MAX_PARTS}")
    widths, outs = [], []
    for v in parts:
        c = 1 if v.ndim == 3 else v.shape[-1]
        cuda_build.check_tensor(v, device, (ny, nx, p) if v.ndim == 3 else (ny, nx, p, c),
                                REAL, "sm_rebucket: payload part")
        if c < 1:
            raise ValueError("sm_rebucket: a payload part has no component")
        widths.append(c)
        outs.append(torch.empty_like(v))
    if not index_fits(ny, nx, p, widths):
        raise ValueError(f"sm_rebucket: {ny} x {nx} x {p} slots with parts of widths {widths} "
                         f"pass the kernel's 32-bit slot index")
    new_pos = torch.empty_like(pos)
    new_mask = torch.empty_like(mask)
    dropped = torch.empty((), dtype=INDEX, device=device)
    args = [mask.data_ptr(), pos.data_ptr(),
            cuda_build.pointer_array([v.data_ptr() for v in parts]),
            cuda_build.pointer_array([o.data_ptr() for o in outs]),
            cuda_build.int_array(widths), len(parts), new_pos.data_ptr(), new_mask.data_ptr(),
            dropped.data_ptr(), p, ny, nx, grid.nx,
            grid.ny if halo is None else halo.ny_total,
            f32_scalar(1.0 / grid.cell_size), f32_scalar(grid.origin[0]),
            f32_scalar(grid.origin[1])]
    name = "sm_rebucket"
    if halo is not None:
        name = "sm_rebucket_halo"
        h_mask, h_pos, *h_parts = halo.planes
        cuda_build.check_tensor(h_mask, device, (2, nx, p), torch.bool,
                                "sm_rebucket: halo mask")
        cuda_build.check_tensor(h_pos, device, (2, nx, p, 2), REAL,
                                "sm_rebucket: halo positions")
        if h_pos.data_ptr() % 8:
            raise ValueError("sm_rebucket: halo positions must be 8-byte aligned (float2)")
        for v, r in zip(parts, h_parts):
            cuda_build.check_tensor(r, device, (2,) + tuple(v.shape[1:]), REAL,
                                    "sm_rebucket: halo payload part")
        args += [h_mask.data_ptr(), h_pos.data_ptr(),
                 cuda_build.pointer_array([r.data_ptr() for r in h_parts]), halo.row0]
    err = getattr(cuda_build.library(), name)(
        *args, torch.cuda.current_stream(device).cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1
    return new_pos, new_mask, tuple(outs), dropped


def sm_rebucket(pos, mask, values, grid: DenseGridConfig):
    """Windowed re-bucket of the padded slot-major state; values (ny, nx, P, D).
    Returns (new_pos, new_mask, new_values, num_dropped); dispatches on
    device."""
    if pos.device.type == "cpu":
        return sm_rebucket_ref(pos, mask, values, grid)
    if values.ndim != 4:
        raise ValueError(f"sm_rebucket: values must be (ny, nx, P, D), got "
                         f"{tuple(values.shape)}")
    new_pos, new_mask, (new_values,), drops = sm_rebucket_parts(pos, mask, (values,), grid)
    return new_pos, new_mask, new_values, drops
