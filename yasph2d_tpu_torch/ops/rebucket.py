"""K2, the per-step neighbourhood rebuild in plane form (PyTorch port of
yasph2d_tpu/ops/pallas_slotmajor.py pf_rebucket).

Every live slot moves to the cell holding its advected position (clamped into
its old 3x3 window by the move code); each target cell compacts the slots that
arrive, in (dyv, dxv, sp) order, into its slots 0..P-1 and passes their
payload (position + value planes) through exactly. Arrivals beyond P are
dropped and counted. `rebucket` launches csrc/rebucket.cu for CUDA tensors and
runs the plain twin `rebucket_ref` for CPU tensors; both are bit-exact.
"""

import torch

from ..units import INDEX, REAL
from . import cuda_build
from .dense_grid import DenseGridConfig
from .planes import pf_move_codes

# kernel launches, counted where the wrapper launches
LAUNCHES = {"rebucket": 0}


def reset_launch_counts():
    LAUNCHES["rebucket"] = 0


def _finish(out: torch.Tensor, total: torch.Tensor, p: int):
    """Split the stacked payload and derive mask and drops from the totals."""
    lane = torch.arange(p, dtype=INDEX, device=total.device)[:, None, None]
    new_mask = lane < total[None]
    num_dropped = torch.clamp(total - p, min=0).sum().to(INDEX)
    return out[0:2], new_mask, out[2:], num_dropped


def rebucket_ref(pos, mask, values, grid: DenseGridConfig):
    """Plain PyTorch twin of K2. pos (2, P, ny, nx), mask (P, ny, nx), values
    (D, P, ny, nx). Returns (new_pos, new_mask, new_values, num_dropped)."""
    p, ny, nx = mask.shape
    code = pf_move_codes(pos, mask, grid)
    src = torch.cat([pos, values], dim=0)  # (n_pay, P, ny, nx)
    code_pad = torch.nn.functional.pad(code, (1, 1, 1, 1))
    src_pad = torch.nn.functional.pad(src, (1, 1, 1, 1))
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
    return _finish(out, total, p)


def rebucket(pos, mask, values, grid: DenseGridConfig):
    """Windowed re-bucket of the plane-form state; dispatches on device."""
    device = pos.device
    if device.type == "cpu":
        return rebucket_ref(pos, mask, values, grid)
    if device.type != "cuda":
        raise ValueError(f"rebucket: unsupported device {device}")
    p, ny, nx = mask.shape
    d = values.shape[0]
    for t, shape, what in ((pos, (2, p, ny, nx), "positions"),
                           (values, (d, p, ny, nx), "values")):
        cuda_build.check_tensor(t, device, shape, REAL, f"rebucket: {what}")
    if mask.device != device or mask.dtype != torch.bool:
        raise ValueError("rebucket: mask must be a CUDA bool tensor")
    code = pf_move_codes(pos, mask, grid)
    n_pay = 2 + d
    step = p * ny * nx * pos.element_size()
    ptrs = [pos.data_ptr() + k * step for k in range(2)]
    ptrs += [values.data_ptr() + k * step for k in range(d)]
    out = torch.empty((n_pay, p, ny, nx), dtype=REAL, device=device)
    total = torch.empty((ny, nx), dtype=INDEX, device=device)
    err = cuda_build.library().rebucket(
        code.data_ptr(), cuda_build.pointer_array(ptrs), n_pay, out.data_ptr(),
        total.data_ptr(), p, ny, nx, torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(err, "rebucket")
    LAUNCHES["rebucket"] += 1
    return _finish(out, total, p)
