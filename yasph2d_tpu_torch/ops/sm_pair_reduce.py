"""K3, the masked pair reduction over each query slot's 3x3 cell neighbourhood
in the padded slot-major layout (PyTorch port of
yasph2d_tpu/ops/pallas_slotmajor.py sm_pair_reduce).

`sm_pair_reduce` dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel of csrc/tile_pair_reduce.cu in K3's sum
order (one instantiation per call form, `sm_pair_reduce_<PairForm.name>`), a
CPU tensor runs the plain PyTorch twin `sm_pair_reduce_ref`. There is no
fallback from one to the other.

Contract (the JAX kernel's): for every live query slot (y, x, p), sum
term_fn(dx, dy, r_sq, r, scalars, q_comps, s_comps) over the source slots of
the 3x3 cells around (y, x) in (dyv, dxv, sp) order, where dx = x_j - x_i and a
pair is valid when the query and the source are live and 1e-10 < r_sq <= h^2.
Dead query slots output zeros. There is no epilogue. Positions are
(ny, nx, P, 2), masks (ny, nx, P), values (ny, nx, P) or (ny, nx, P, C) (a
vector contributes its C components, in order); the source space may have
Ps != P slots. The output is (ny, nx, P, n_out), vector-last like the carry.

Launch shape: K5's (ops/pallas_pair.py `tile_shape`, `smem_bytes`,
`query_round`): K3 runs on K5's tile machinery, any P and any Ps whose
haloed source tile fits a block.
"""

from typing import Callable

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ
from .pair_reduce import PairForm
from .pallas_pair import _comps, gated_tile_launcher, tile_launch, tile_shape

# kernel launches per call form, counted where the wrapper launches
LAUNCHES = {form: 0 for form in cuda_build.SM_PAIR_FORMS}


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


def sm_pair_reduce_ref(term_fn, n_out: int, q_pos, q_mask, s_pos, s_mask,
                       radius_sq: float, q_vals=(), s_vals=(), scalars=()):
    """Plain PyTorch twin of K3: nine shifted views of the one-cell-padded
    source space; per view the terms of all Ps source slots are evaluated at
    once ((ny, nx, P, Ps) candidates) and added slot by slot, which keeps the
    kernel's (dyv, dxv, sp) order. Returns (ny, nx, P, n_out)."""
    ny, nx, _ = q_mask.shape
    ps = s_mask.shape[2]

    def pad(a):  # one dead cell ring around the grid (dims 0 and 1)
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    s_pos = pad(s_pos)
    s_mask = pad(s_mask)
    s_comps = [pad(c) for c in _comps(s_vals)]
    qx, qy = q_pos[..., 0, None], q_pos[..., 1, None]  # (ny, nx, P, 1)
    q_comps = tuple(c[..., None] for c in _comps(q_vals))
    q_live = q_mask[..., None]
    radius_sq = torch.tensor(radius_sq, dtype=q_pos.dtype, device=q_pos.device)
    accs = [torch.zeros_like(q_pos[..., 0]) for _ in range(n_out)]
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            dx = s_pos[rows, cols, None, :, 0] - qx
            dy = s_pos[rows, cols, None, :, 1] - qy
            r_sq = dx * dx + dy * dy
            valid = (
                q_live & s_mask[rows, cols, None, :]
                & (r_sq <= radius_sq) & (r_sq > MIN_DISTANCE_SQ)
            )
            s_planes = tuple(c[rows, cols, None, :] for c in s_comps)
            outs = term_fn(dx, dy, r_sq, torch.sqrt(r_sq), scalars, q_comps, s_planes)
            for sp in range(ps):
                # where, not a multiply: invalid candidates may hold inf/NaN
                accs = [a + torch.where(valid[..., sp], o[..., sp], 0.0)
                        for a, o in zip(accs, outs)]
    return torch.stack(accs, dim=-1)


def launch(form: PairForm, q_pos, q_mask, s_pos, s_mask, consts: cuda_build.PairConsts,
           q_vals, s_vals, scalars, tile) -> torch.Tensor:
    """Launch K3's instantiation of `form` on CUDA tensors with the launch shape
    `tile` = (TY, TX, threads); returns (ny, nx, P, n_out). Counts nothing:
    `sm_pair_reduce` is the solvers' entry (tools/tile_sweep.py --kernel k3
    times other shapes through this)."""
    return tile_launch("sm_pair_reduce", form, q_pos, q_mask, s_pos, s_mask, consts,
                       q_vals, s_vals, scalars, tile)


def loop_launcher(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                  consts: cuda_build.PairConsts, q_vals, s_vals, out, state) -> Callable:
    """K3's `form` (no scalar) into `out`, gated on a pressure loop's
    `state`, as a function of the iteration (ops/pallas_pair.py
    `loop_launcher`); counted as `sm_pair_reduce` counts."""
    def twin():
        return sm_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos, s_mask,
                                  consts.radius_sq, q_vals=q_vals, s_vals=s_vals)

    def count():
        LAUNCHES[form.name] += 1
    return gated_tile_launcher("sm_pair_reduce", form, q_pos, q_mask, s_pos, s_mask, consts,
                               q_vals, s_vals, out, state, None, twin, count)


def sm_pair_reduce(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                   consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                   scalars=()) -> torch.Tensor:
    """Run one K3 call form; returns (ny, nx, P, n_out). `consts.radius_sq` is
    the pair cutoff for both routes; the launch shape is K5's `tile_shape`."""
    if form.post_fn is not None:
        raise ValueError("sm_pair_reduce: K3 forms have no epilogue")
    device = q_pos.device
    if device.type == "cpu":
        return sm_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos,
                                  s_mask, consts.radius_sq, q_vals=q_vals,
                                  s_vals=s_vals, scalars=scalars)
    if device.type != "cuda":
        raise ValueError(f"sm_pair_reduce: unsupported device {device}")
    tile = tile_shape(q_mask.shape[2], s_mask.shape[2], len(_comps(s_vals)))
    out = launch(form, q_pos, q_mask, s_pos, s_mask, consts, q_vals, s_vals, scalars, tile)
    LAUNCHES[form.name] += 1
    return out
