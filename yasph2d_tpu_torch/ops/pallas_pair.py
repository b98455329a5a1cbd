"""K5, the gen-1 pair reduction on shared-memory cell tiles (PyTorch port of
yasph2d_tpu/ops/pallas_pair.py pallas_pair_reduce; the module keeps that name).

The JAX kernel is the drop-in for the XLA `dense_grid.pair_reduce`, with the
same contract; the port's padded solvers run every pair pass on it when
`DenseGridConfig.use_pallas_slotmajor` is False. `pallas_pair_reduce`
dispatches on the device of its tensors: a CUDA tensor launches the
hand-written kernel of csrc/tile_pair_reduce.cu (one instantiation per call
form, named by `PairForm.name`), a CPU tensor runs the plain PyTorch twin
`pallas_pair_reduce_ref`. There is no fallback from one to the other.

Contract (the JAX kernel's, pallas_pair.py:40-94): for every live query slot
(y, x, p), the sum over the nine neighbour-cell views, in (dy, dx) order, of
the per-view sum over the Ps source slots of
term_fn(dx, dy, r_sq, r, scalars, q_comps, s_comps), where dx = x_j - x_i and
a candidate is valid when the query and the source are live and
1e-10 < r_sq <= h^2 (selected with `where`: dead sources may give inf/NaN).
Dead query slots output zeros. Positions are (ny, nx, P, 2), masks
(ny, nx, P), values (ny, nx, P) or (ny, nx, P, C); the source space may have
Ps != P slots. The output is (ny, nx, P, n_out), vector-last like K3's. The
forms' terms follow the JAX package's XLA closures (csrc/pair_terms.cuh
*XlaTerm), not K3's slot-major order.
"""

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ
from .pair_reduce import PairForm
from .sm_pair_reduce import _comps, slot_operands

# kernel launches per call form, counted where the wrapper launches
LAUNCHES = {form: 0 for form in cuda_build.TILE_PAIR_FORMS}

BLOCK_ROWS = 8
BLOCK_COLS = (32, 16, 8, 4, 2, 1)  # the widest tile that fits is taken
# a block's threads: one per query slot of the tile, at most this many (at
# 100k, 8 x 8 x 7 tiles of 448 threads beat 896 and 1024: tools/tile_sweep.py)
MAX_THREADS = 512
SMEM_LIMIT = cuda_build.SMEM_LIMIT


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


def pallas_pair_reduce_ref(term_fn, n_out: int, q_pos, q_mask, s_pos, s_mask,
                           radius_sq: float, q_vals=(), s_vals=(), scalars=()):
    """Plain PyTorch twin of K5: nine shifted views of the one-cell-padded
    source space; each view evaluates the terms of all Ps source slots at once
    ((ny, nx, P, Ps) candidates), sums them over Ps with torch.sum, and the
    view sums are added in (dy, dx) order. Returns (ny, nx, P, n_out)."""
    ny, nx, _ = q_mask.shape

    def pad(a):  # one dead cell ring around the grid (dims 0 and 1)
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    s_pos = pad(s_pos)
    s_mask = pad(s_mask)
    s_comps = [pad(c) for c in _comps(s_vals)]
    qx, qy = q_pos[..., 0, None], q_pos[..., 1, None]  # (ny, nx, P, 1)
    q_comps = tuple(c[..., None] for c in _comps(q_vals))
    q_live = q_mask[..., None]
    radius_sq = torch.tensor(radius_sq, dtype=q_pos.dtype, device=q_pos.device)
    accs = None
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
            # where, not a multiply: invalid candidates may hold inf/NaN
            views = [torch.sum(torch.where(valid, o, 0.0), dim=-1) for o in outs]
            accs = views if accs is None else [a + v for a, v in zip(accs, views)]
    return torch.stack(accs, dim=-1)


def tile_shape(p: int, ps: int, n_source_comps: int) -> tuple:
    """(BR, BC, threads) of a launch: BR = BLOCK_ROWS and the widest BC of
    BLOCK_COLS whose BR x BC x P query slots take at most MAX_THREADS threads
    and whose haloed (BR + 2) x (BC + 2) x Ps source tile (float2 position,
    the source values, a mask byte) fits in the shared memory of one block;
    raises if not even one column fits."""
    per_slot = 8 + 4 * n_source_comps + 1
    fits = [bc for bc in BLOCK_COLS
            if (BLOCK_ROWS + 2) * (bc + 2) * ps * per_slot <= SMEM_LIMIT]
    if not fits:
        need = (BLOCK_ROWS + 2) * 3 * ps * per_slot
        raise ValueError(
            f"pallas_pair_reduce: a {BLOCK_ROWS} x 1 cell tile with Ps = {ps} source "
            f"slots and {n_source_comps} source values needs {need} bytes of shared "
            f"memory; a block has {SMEM_LIMIT}"
        )
    bc = next((c for c in fits if BLOCK_ROWS * c * p <= MAX_THREADS), fits[-1])
    threads = min(MAX_THREADS, -(-BLOCK_ROWS * bc * p // 32) * 32)
    return BLOCK_ROWS, bc, threads


def launch(form: PairForm, q_pos, q_mask, s_pos, s_mask, consts: cuda_build.PairConsts,
           q_vals, s_vals, scalars, tile) -> torch.Tensor:
    """Launch K5's instantiation of `form` on CUDA tensors with the launch shape
    `tile` = (BR, BC, threads); returns (ny, nx, P, n_out). Counts nothing:
    `pallas_pair_reduce` is the solvers' entry (tools/tile_sweep.py times other
    shapes through this)."""
    (ny, nx, p, ps), ptrs, strides, scalar = slot_operands(
        "pallas_pair_reduce", q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars)
    br, bc, threads = tile
    out = torch.empty((ny, nx, p, form.n_out), dtype=torch.float32, device=q_pos.device)
    fn = getattr(cuda_build.library(), f"tile_pair_reduce_{form.name}")
    err = fn(
        q_pos.data_ptr(), q_mask.data_ptr(), s_pos.data_ptr(), s_mask.data_ptr(),
        cuda_build.pointer_array(ptrs), cuda_build.int_array(strides), len(ptrs),
        out.data_ptr(), p, ps, ny, nx, br, bc, threads, scalar, consts,
        torch.cuda.current_stream(q_pos.device).cuda_stream,
    )
    cuda_build.check(err, f"tile_pair_reduce_{form.name}")
    return out


def pallas_pair_reduce(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                       consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                       scalars=()) -> torch.Tensor:
    """Run one K5 call form; returns (ny, nx, P, n_out). `consts.radius_sq` is
    the pair cutoff for both routes; the launch shape is `tile_shape`'s."""
    if form.post_fn is not None:
        raise ValueError("pallas_pair_reduce: K5 forms have no epilogue")
    device = q_pos.device
    if device.type == "cpu":
        return pallas_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos,
                                      s_mask, consts.radius_sq, q_vals=q_vals,
                                      s_vals=s_vals, scalars=scalars)
    if device.type != "cuda":
        raise ValueError(f"pallas_pair_reduce: unsupported device {device}")
    tile = tile_shape(q_mask.shape[2], s_mask.shape[2], len(_comps(s_vals)))
    out = launch(form, q_pos, q_mask, s_pos, s_mask, consts, q_vals, s_vals, scalars,
                 tile)
    LAUNCHES[form.name] += 1
    return out
