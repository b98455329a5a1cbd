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

Halo form (spatial sharding, parallel/shard_dense.py): with a `planes.Halo`
of the neighbouring shards' rows -1 and ny of the source (positions
(2, nx, Ps, 2), mask (2, nx, Ps), then each source value (2, nx, Ps[, C]) in
the order of `s_vals`; row -1 at index 0, dead at the ends of the mesh),
those rows are the source's rows -1 and ny instead of the dead ring, so a
shard's rows get the one-device sums of the whole grid. This is the JAX
package's XLA `dense_grid.pair_reduce` with `grid.halo_axis` set, which
its sharded padded route runs; its Pallas kernel would pad zeros there
(`halo2d`) and lose the neighbours across the seam, so the port's K5
takes the exchanged rows whatever `use_pallas` says. The CUDA launchers
are the halo instantiations of the same kernel (csrc/tile_pair_reduce_halo.cu),
counted under `<form>_halo`; the rows stage into the tile's ring, so the
shared memory and launch shape are the one-device form's.
"""

from typing import Optional

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ
from .pair_reduce import PairForm
from .planes import Halo

# kernel launches per call form (halo forms under "<form>_halo"), counted where
# the wrapper launches
LAUNCHES = {f"{form}{suffix}": 0 for suffix in ("", "_halo")
            for form in cuda_build.TILE_PAIR_FORMS}

# (TY, TX, threads) of a launch, both sides powers of two, at most 256 threads
# (csrc/tile_pair_reduce.cu K5_MAX_THREADS): tools/tile_sweep.py --kernel k5
# on the 100k padded states, and for K3 --kernel k3 (within 1% of the best
# shape on every loop form); tile_shape halves it where it does not fit
TILE = (8, 8, 256)
MAX_ROUND = 8192  # query slots whose live list a block holds at once
SMEM_LIMIT = cuda_build.SMEM_LIMIT


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


def _comps(vals) -> list:
    """Logical (ny, nx, P) components of slot-layout values."""
    out = []
    for v in vals:
        out.extend([v] if v.ndim == 3 else list(v.unbind(-1)))
    return out


def _halo_rows(halo: Optional[Halo], s_vals) -> Optional[tuple]:
    """(positions, mask, value components) rows of a source halo, or None;
    raises unless it holds one row pair per source value."""
    if halo is None:
        return None
    h_pos, h_mask, *h_vals = halo.planes
    if len(h_vals) != len(s_vals):
        raise ValueError(f"pallas_pair_reduce: {len(h_vals)} halo value rows for "
                         f"{len(s_vals)} source values")
    return h_pos, h_mask, _comps(h_vals)


def pallas_pair_reduce_ref(term_fn, n_out: int, q_pos, q_mask, s_pos, s_mask,
                           radius_sq: float, q_vals=(), s_vals=(), scalars=(),
                           halo: Optional[Halo] = None):
    """Plain PyTorch twin of K5: nine shifted views of the one-cell-padded
    source space; each view evaluates the terms of all Ps source slots at once
    ((ny, nx, P, Ps) candidates), sums them over Ps with torch.sum, and the
    view sums are added in (dy, dx) order. Returns (ny, nx, P, n_out). With a
    `halo` the ring's rows -1 and ny are its rows (module docstring)."""
    ny, nx, _ = q_mask.shape
    rows = _halo_rows(halo, s_vals)

    def pad(a, r=None):  # a cell ring around the grid (dims 0 and 1): dead, or
        lead = (0, 0) * (a.ndim - 2)  # rows -1 and ny from the halo
        if r is None:
            return torch.nn.functional.pad(a, lead + (1, 1, 1, 1))
        return torch.nn.functional.pad(torch.cat([r[:1], a, r[1:]]), lead + (1, 1, 0, 0))

    if rows is None:
        s_pos = pad(s_pos)
        s_mask = pad(s_mask)
        s_comps = [pad(c) for c in _comps(s_vals)]
    else:
        s_pos = pad(s_pos, rows[0])
        s_mask = pad(s_mask, rows[1])
        s_comps = [pad(c, r) for c, r in zip(_comps(s_vals), rows[2])]
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


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def query_round(ty: int, tx: int, p: int) -> int:
    """Query slots a block scans per round: its tile's TY x TX x PP slots (PP
    the power of two >= P), at most MAX_ROUND."""
    return min(ty * tx * _pow2(p), MAX_ROUND)


def smem_bytes(ty: int, tx: int, p: int, ps: int, n_source_comps: int) -> int:
    """Dynamic shared memory of one K5 block (csrc/tile_pair_reduce.cu
    TileSmem): the haloed source tile's float2 positions and source values,
    its live words (ceil(Ps / 32) a cell), the round's live list (uint16) and
    32 warp counts."""
    hc = (ty + 2) * (tx + 2)
    return (_align16(hc * ps * 8) + _align16(hc * ps * 4 * n_source_comps)
            + _align16(hc * -(-ps // 32) * 4) + _align16(query_round(ty, tx, p) * 2) + 32 * 4)


def tile_shape(p: int, ps: int, n_source_comps: int) -> tuple:
    """(TY, TX, threads) of a launch: TILE, halved (the longer side, TY on a tie)
    until its block fits in the shared memory of one block; raises if not
    even a 1 x 1 tile fits."""
    ty, tx, threads = TILE
    while smem_bytes(ty, tx, p, ps, n_source_comps) > SMEM_LIMIT:
        if ty == tx == 1:
            raise ValueError(
                f"pallas_pair_reduce: a 1 x 1 cell tile with Ps = {ps} source slots and "
                f"{n_source_comps} source values needs "
                f"{smem_bytes(1, 1, p, ps, n_source_comps)} bytes of shared memory; a "
                f"block has {SMEM_LIMIT}")
        if ty >= tx:
            ty //= 2
        else:
            tx //= 2
    return ty, tx, threads


def _value_ptrs(vals, device, shape, what):
    """(pointer, element stride) of each logical component, no copy: a scalar
    is (base, 1), component k of a (.., C) vector is (base + k, C)."""
    ptrs, strides = [], []
    for v in vals:
        c = 1 if v.ndim == 3 else v.shape[-1]
        cuda_build.check_tensor(v, device, shape if v.ndim == 3 else shape + (c,),
                                torch.float32, what)
        ptrs.extend(v.data_ptr() + k * v.element_size() for k in range(c))
        strides.extend([c] * c)
    return ptrs, strides


def slot_operands(kernel: str, q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars):
    """Check the operands of a slot-major pair kernel (K3, K5) and return
    ((ny, nx, P, Ps), value pointers, value strides, the f32 scalar)."""
    device = q_pos.device
    ny, nx, p = q_mask.shape
    ps = s_mask.shape[2]
    for t, shape, dtype, what in (
            (q_pos, (ny, nx, p, 2), torch.float32, "query positions"),
            (q_mask, (ny, nx, p), torch.bool, "query mask"),
            (s_pos, (ny, nx, ps, 2), torch.float32, "source positions"),
            (s_mask, (ny, nx, ps), torch.bool, "source mask")):
        cuda_build.check_tensor(t, device, shape, dtype, f"{kernel}: {what}")
    if q_pos.data_ptr() % 8 or s_pos.data_ptr() % 8:
        raise ValueError(f"{kernel}: positions must be 8-byte aligned (float2)")
    if len(scalars) > 1:
        raise ValueError(f"{kernel}: the CUDA forms take at most one scalar")
    q_ptrs, q_strides = _value_ptrs(q_vals, device, (ny, nx, p), f"{kernel}: query value")
    s_ptrs, s_strides = _value_ptrs(s_vals, device, (ny, nx, ps),
                                    f"{kernel}: source value")
    return ((ny, nx, p, ps), q_ptrs + s_ptrs, q_strides + s_strides,
            float(scalars[0]) if scalars else 0.0)


def halo_operands(halo: Halo, s_vals, device, nx: int, ps: int) -> tuple:
    """Check a K5 source halo's rows (module docstring) and return the
    pointers (positions, mask, [value component pointers]); each value's
    rows have the layout, and so the strides, of its grid tensor."""
    h_pos, h_mask, *h_vals = halo.planes
    if len(h_vals) != len(s_vals):
        raise ValueError(f"pallas_pair_reduce: {len(h_vals)} halo value rows for "
                         f"{len(s_vals)} source values")
    cuda_build.check_tensor(h_pos, device, (2, nx, ps, 2), torch.float32,
                            "pallas_pair_reduce: halo positions")
    cuda_build.check_tensor(h_mask, device, (2, nx, ps), torch.bool,
                            "pallas_pair_reduce: halo mask")
    if h_pos.data_ptr() % 8:
        raise ValueError("pallas_pair_reduce: halo positions must be 8-byte aligned (float2)")
    ptrs = []
    for v, r in zip(s_vals, h_vals):
        if r.shape[2:] != v.shape[2:]:
            raise ValueError(f"pallas_pair_reduce: halo value rows {tuple(r.shape)} for a "
                             f"source value {tuple(v.shape)}")
        ptrs += _value_ptrs((r,), device, (2, nx, ps), "pallas_pair_reduce: halo value")[0]
    return h_pos.data_ptr(), h_mask.data_ptr(), ptrs


def tile_launch(kernel: str, form: PairForm, q_pos, q_mask, s_pos, s_mask,
                consts: cuda_build.PairConsts, q_vals, s_vals, scalars, tile,
                halo: Optional[Halo] = None) -> torch.Tensor:
    """Launch `kernel`'s instantiation of `form` (csrc/tile_pair_reduce.cu:
    `tile_pair_reduce`, K5's sum order, or `sm_pair_reduce`, K3's) on CUDA
    tensors with the launch shape `tile` = (TY, TX, threads); returns
    (ny, nx, P, n_out). A `halo` (K5 only) launches the form's halo
    instantiation (csrc/tile_pair_reduce_halo.cu). Counts nothing."""
    (ny, nx, p, ps), ptrs, strides, scalar = slot_operands(
        kernel, q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars)
    ty, tx, threads = tile
    n_sv = len(_comps(s_vals))
    out = torch.empty((ny, nx, p, form.n_out), dtype=torch.float32, device=q_pos.device)
    name, extra = f"{kernel}_{form.name}", ()
    if halo is not None:
        if kernel != "tile_pair_reduce":
            raise ValueError(f"{kernel}: no halo form (K5's sum order only)")
        h_pos, h_mask, h_ptrs = halo_operands(halo, s_vals, q_pos.device, nx, ps)
        name += "_halo"
        extra = (h_pos, h_mask, cuda_build.pointer_array(h_ptrs))
    err = getattr(cuda_build.library(), name)(
        q_pos.data_ptr(), q_mask.data_ptr(), s_pos.data_ptr(), s_mask.data_ptr(),
        cuda_build.pointer_array(ptrs), cuda_build.int_array(strides), len(ptrs),
        out.data_ptr(), p, ps, ny, nx, ty, tx, threads, query_round(ty, tx, p),
        smem_bytes(ty, tx, p, ps, n_sv), scalar, *extra, consts,
        torch.cuda.current_stream(q_pos.device).cuda_stream,
    )
    cuda_build.check(err, name)
    return out


def launch(form: PairForm, q_pos, q_mask, s_pos, s_mask, consts: cuda_build.PairConsts,
           q_vals, s_vals, scalars, tile, halo: Optional[Halo] = None) -> torch.Tensor:
    """Launch K5's instantiation of `form` (its halo form with a `halo`) on
    CUDA tensors with the launch shape `tile` = (TY, TX, threads); returns
    (ny, nx, P, n_out). Counts nothing: `pallas_pair_reduce` is the solvers'
    entry (tools/tile_sweep.py times other shapes through this)."""
    return tile_launch("tile_pair_reduce", form, q_pos, q_mask, s_pos, s_mask, consts,
                       q_vals, s_vals, scalars, tile, halo)


def pallas_pair_reduce(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                       consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                       scalars=(), halo: Optional[Halo] = None) -> torch.Tensor:
    """Run one K5 call form; returns (ny, nx, P, n_out). `consts.radius_sq` is
    the pair cutoff for both routes; the launch shape is `tile_shape`'s, with
    or without a `halo` (the source's rows -1 and ny, module docstring)."""
    if form.post_fn is not None:
        raise ValueError("pallas_pair_reduce: K5 forms have no epilogue")
    device = q_pos.device
    if device.type == "cpu":
        return pallas_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos,
                                      s_mask, consts.radius_sq, q_vals=q_vals,
                                      s_vals=s_vals, scalars=scalars, halo=halo)
    if device.type != "cuda":
        raise ValueError(f"pallas_pair_reduce: unsupported device {device}")
    tile = tile_shape(q_mask.shape[2], s_mask.shape[2], len(_comps(s_vals)))
    out = launch(form, q_pos, q_mask, s_pos, s_mask, consts, q_vals, s_vals, scalars,
                 tile, halo)
    LAUNCHES[form.name + ("" if halo is None else "_halo")] += 1
    return out
