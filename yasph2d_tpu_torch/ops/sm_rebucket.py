"""K4, the per-step neighbourhood rebuild in the padded slot-major layout
(PyTorch port of yasph2d_tpu/ops/pallas_slotmajor.py sm_rebucket).

The same re-bucket as K2 (ops/rebucket.py), on the solver carry's own layout:
every live slot moves to the cell holding its advected position (clamped into
its old 3x3 window by the move code); each target cell compacts the slots that
arrive, in (dyv, dxv, sp) order, into its slots 0..P-1 and passes their
position and values through exactly. Arrivals beyond P are dropped and
counted. `sm_rebucket` launches csrc/sm_rebucket.cu for CUDA tensors and runs
the plain twin `sm_rebucket_ref` for CPU tensors; both are bit-exact.
"""

import torch

from ..units import INDEX, REAL
from . import cuda_build
from .dense_grid import DenseGridConfig, move_codes

# kernel launches, counted where the wrapper launches
LAUNCHES = {"sm_rebucket": 0}


def reset_launch_counts():
    LAUNCHES["sm_rebucket"] = 0


def _mask_and_drops(total: torch.Tensor, p: int):
    """Slot mask and drop count from the per-cell incoming totals."""
    lane = torch.arange(p, dtype=INDEX, device=total.device)
    new_mask = lane < total[..., None]
    num_dropped = torch.clamp(total - p, min=0).sum().to(INDEX)
    return new_mask, num_dropped


def sm_rebucket_ref(pos, mask, values, grid: DenseGridConfig):
    """Plain PyTorch twin of K4. pos (ny, nx, P, 2), mask (ny, nx, P), values
    (ny, nx, P, D). Returns (new_pos, new_mask, new_values, num_dropped)."""
    ny, nx, p = mask.shape
    code = move_codes(pos, mask, grid)
    src = torch.cat([pos, values], dim=-1)  # (ny, nx, P, 2 + D)
    code_pad = torch.nn.functional.pad(code, (0, 0, 1, 1, 1, 1))
    src_pad = torch.nn.functional.pad(src, (0, 0, 0, 0, 1, 1, 1, 1))
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
    new_mask, num_dropped = _mask_and_drops(total, p)
    return out[..., :2], new_mask, out[..., 2:], num_dropped


def sm_rebucket(pos, mask, values, grid: DenseGridConfig):
    """Windowed re-bucket of the padded slot-major state; dispatches on device."""
    device = pos.device
    if device.type == "cpu":
        return sm_rebucket_ref(pos, mask, values, grid)
    if device.type != "cuda":
        raise ValueError(f"sm_rebucket: unsupported device {device}")
    ny, nx, p = mask.shape
    d = values.shape[-1]
    for t, shape, dtype, what in ((pos, (ny, nx, p, 2), REAL, "positions"),
                                  (mask, (ny, nx, p), torch.bool, "mask"),
                                  (values, (ny, nx, p, d), REAL, "values")):
        cuda_build.check_tensor(t, device, shape, dtype, f"sm_rebucket: {what}")
    code = move_codes(pos, mask, grid)
    new_pos = torch.empty((ny, nx, p, 2), dtype=REAL, device=device)
    new_values = torch.empty((ny, nx, p, d), dtype=REAL, device=device)
    total = torch.empty((ny, nx), dtype=INDEX, device=device)
    err = cuda_build.library().sm_rebucket(
        code.data_ptr(), pos.data_ptr(), values.data_ptr(), d, new_pos.data_ptr(),
        new_values.data_ptr(), total.data_ptr(), p, ny, nx,
        torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(err, "sm_rebucket")
    LAUNCHES["sm_rebucket"] += 1
    new_mask, num_dropped = _mask_and_drops(total, p)
    return new_pos, new_mask, new_values, num_dropped
