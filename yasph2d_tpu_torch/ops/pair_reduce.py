"""K1, the masked pair reduction over each query slot's 3x3 cell neighbourhood
(PyTorch port of yasph2d_tpu/ops/pallas_slotmajor.py pf_pair_reduce).

`pair_reduce` dispatches on the device of its tensors: a CUDA tensor launches
the hand-written kernel of csrc/pair_reduce.cuh (one instantiation per call
form, named by `PairForm.name`; its launchers in csrc/pair_reduce.cu), a CPU
tensor runs the plain PyTorch twin
`pair_reduce_ref`. There is no fallback from one to the other.

Contract (the JAX kernel's): for every live query slot, sum
term_fn(dx, dy, r_sq, r, scalars, q_planes, s_planes) over the source slots of
the 3x3 cells around it in (dyv, dxv, sp) order, where dx = x_j - x_i and a
pair is valid when the source is live and 1e-10 < r_sq <= h^2; then map the
n_acc accumulators through post_fn(accs, post_planes, scalars) if given. Dead
query slots output zeros.

bfloat16 operands (the JAX kernel's `rebase_cell` mode, selected by a
geometry from `planes.plane_geom` on a bfloat16 grid): positions are bf16
offsets from each slot's cell centre and every query and source value plane
is rounded to bf16 (round to nearest even) at load; both upcast to f32, and
dx = (x_j - x_i) + f32((dxv - 1) * h) on every view, dy likewise. All math
and accumulation stay f32 and post planes stay exact f32. The CUDA forms of
this mode launch and count under `<form>_bf16`.

Halo form (spatial sharding, parallel/shard_plane.py): a source geometry with
a `halo` (planes.Halo of its positions and mask) and `s_halo`, the same rows
of every source value plane, make source rows -1 and ny the neighbouring
shards' rows instead of dead cells; everything else is the one-device
contract, so a shard's output equals the one-device output on its rows. The
JAX kernel reads them from its halo-exchanged source windows
(`_pf_block_source(halo=...)`). Its CUDA launchers are the halo
instantiations of the same kernel (csrc/pair_reduce_halo.cu) and count under
`<form>_halo` / `<form>_bf16_halo`.

Launch shape: one CUDA block per TY x TX cell tile (csrc/pair_reduce.cuh), its
threads and its dynamic shared memory from `tile_shape`, which widens the
tile on large grids. Any source space whose tile fits a block: a cell's live
list is ceil(Ps / 32) 32-bit words.
"""

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ, f32_scalar
from .planes import PlaneGeom

# kernel launches per call form, counted where the wrapper launches; the
# bfloat16-operand forms count under "<form>_bf16", the halo forms under
# "<form>_halo" and "<form>_bf16_halo"
LAUNCHES = {f"{form}{suffix}": 0 for suffix in ("", "_bf16", "_halo", "_bf16_halo")
            for form in cuda_build.PAIR_FORMS}

# (TY, TX, threads) launch shapes, widest first; TY and TX powers of two. A
# busy tile (one with a live query) wants threads for its candidate loops,
# every tile costs a scan of its query masks: the widest tile whose grid has
# at least MIN_BLOCKS blocks, else the narrowest. On the H100
# (tools/tile_sweep.py --kernel k1) the loop forms ran fastest on 8 x 8 at
# 100k (2,665 blocks) and on 8 x 32 at 1M (6,477 blocks).
TILES = ((8, 32, 256), (8, 16, 256), (8, 8, 256))
MIN_BLOCKS = 4096  # ~31 blocks per SM of the H100


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


@dataclass(frozen=True)
class PairForm:
    """One call form of K1 (and of K3 and K5): the CUDA instantiation's name
    and the same math as Python callables for the twin. `n_acc` defaults to
    n_out. `bf16`: a K5 form in its bf16 math mode (ops/pallas_pair.py
    bf16_form), whose calls must pass a rebase."""

    name: str
    n_out: int
    term_fn: Callable
    post_fn: Optional[Callable] = None
    n_acc: Optional[int] = None
    bf16: bool = False


def _operand_mode(q: PlaneGeom, s: PlaneGeom):
    """The views' centre deltas (None in float32 mode) and the value loader of
    the geometries' operand mode; raises unless both were built alike."""
    if q.rebase_cell != s.rebase_cell or q.pos.dtype != s.pos.dtype:
        raise ValueError(
            f"pair_reduce: query and source geometry differ in operand mode "
            f"({q.pos.dtype}, rebase {q.rebase_cell}) vs ({s.pos.dtype}, rebase "
            f"{s.rebase_cell}): build both with planes.plane_geom on one grid")
    want = torch.float32 if q.rebase_cell is None else torch.bfloat16
    if q.pos.dtype != want:
        raise ValueError(f"pair_reduce: {q.pos.dtype} positions with rebase cell "
                         f"{q.rebase_cell}; expected {want}")
    if q.rebase_cell is None:
        return None, lambda a: a
    h = q.rebase_cell
    return ((f32_scalar(-h), 0.0, f32_scalar(h)),
            lambda a: a.to(torch.bfloat16).to(torch.float32))


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def smem_bytes(ty: int, tx: int, p: int, ps: int, n_source_vals: int, bf16: bool) -> int:
    """Dynamic shared memory of one K1 block on a TY x TX cell tile
    (csrc/pair_reduce.cuh SmemLayout): the haloed tile's positions and source
    values (f32, or bf16 with bf16 operands), ceil(Ps / 32) live-list words
    per haloed cell, the tile's live query list (uint16 per query slot) and
    32 warp counts, each region rounded up to 16 bytes."""
    hc = (ty + 2) * (tx + 2)
    w = 2 if bf16 else 4
    return (_align16(hc * ps * 2 * w) + _align16(hc * ps * n_source_vals * w)
            + _align16(hc * -(-ps // 32) * 4) + _align16(ty * tx * p * 2) + 32 * 4)


def tile_shape(p: int, ps: int, n_source_vals: int, bf16: bool, ny: int, nx: int) -> tuple:
    """(TY, TX, threads, shared-memory bytes) of a K1 launch on a ny x nx
    grid: of the TILES whose block fits (shared memory, at most 65,536 query
    slots a tile), the widest with at least MIN_BLOCKS blocks, else the
    narrowest. Raises when none fits."""
    fits = [(ty, tx, threads, smem_bytes(ty, tx, p, ps, n_source_vals, bf16))
            for ty, tx, threads in TILES if ty * tx * p <= 65536]
    fits = [t for t in fits if t[3] <= cuda_build.SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"pair_reduce: no cell tile of {TILES} fits P = {p}, Ps = {ps} and "
            f"{n_source_vals} source values in a block's {cuda_build.SMEM_LIMIT} bytes of "
            f"shared memory")
    return next((t for t in fits if -(-ny // t[0]) * -(-nx // t[1]) >= MIN_BLOCKS), fits[-1])


def _planes(vals: Sequence[torch.Tensor]) -> list:
    """Logical (·, ny, nx) planes of plane-form values: a (P, ny, nx) scalar is
    one plane, a (L, P, ny, nx) stack contributes L planes in order."""
    out = []
    for v in vals:
        out.extend([v] if v.ndim == 3 else list(v.unbind(0)))
    return out


def _source_halo(s: PlaneGeom, s_vals, s_halo) -> Optional[list]:
    """The halo rows of the source value planes, one (Ps, 2, nx) per logical
    plane (`s_halo` has the structure of `s_vals`), or None without a
    geometry halo; raises when the two disagree."""
    n_planes, rows = len(_planes(s_vals)), _planes(s_halo)
    if s.halo is None:
        if rows:
            raise ValueError("pair_reduce: value halo rows without a geometry halo")
        return None
    if len(rows) != n_planes:
        raise ValueError(f"pair_reduce: {len(rows)} value halo rows for {n_planes} "
                         "source value planes")
    return rows


def pair_reduce_ref(term_fn, n_out: int, q: PlaneGeom, s: PlaneGeom,
                    radius_sq: float, q_vals=(), s_vals=(), scalars=(),
                    post_fn=None, post_planes=(), n_acc: int = None,
                    s_halo=()) -> torch.Tensor:
    """Plain PyTorch twin of K1: nine shifted views of the one-cell-padded
    source planes; per view the terms of all Ps source slots are evaluated at
    once ((Ps, P, ny, nx) candidates) and added slot by slot, which keeps the
    kernel's (dyv, dxv, sp) order. Returns (n_out, P, ny, nx). A bfloat16
    geometry selects the bf16 operand mode (module docstring); a geometry
    halo the halo form, with `s_halo` the value planes' rows."""
    _, ny, nx = q.mask.shape
    ps = s.mask.shape[0]
    n_acc = n_out if n_acc is None else n_acc
    deltas, load = _operand_mode(q, s)
    val_rows = _source_halo(s, s_vals, s_halo)

    def pad(a, rows=None):  # a cell ring around the grid: dead, or rows -1, ny from the halo
        if rows is None:
            return torch.nn.functional.pad(a, (1, 1, 1, 1))
        a = torch.cat([rows[..., :1, :], a, rows[..., 1:, :]], dim=-2)
        return torch.nn.functional.pad(a, (1, 1, 0, 0))

    if s.halo is None:
        s_pos, s_mask = pad(s.pos.to(torch.float32)), pad(s.mask)
        s_planes_all = [pad(load(a)) for a in _planes(s_vals)]
    else:
        h_pos, h_mask = s.halo.planes
        s_pos = pad(s.pos.to(torch.float32), h_pos.to(torch.float32))
        s_mask = pad(s.mask, h_mask)
        s_planes_all = [pad(load(a), load(r)) for a, r in zip(_planes(s_vals), val_rows)]
    qx, qy = q.pos[0].to(torch.float32), q.pos[1].to(torch.float32)
    q_planes = tuple(load(a) for a in _planes(q_vals))
    radius_sq = torch.tensor(radius_sq, dtype=torch.float32, device=q.pos.device)
    accs = [torch.zeros_like(qx) for _ in range(n_acc)]
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            dx = s_pos[0, :, None, rows, cols] - qx
            dy = s_pos[1, :, None, rows, cols] - qy
            if deltas is not None:  # the views' centre offsets, on every view
                dx = dx + deltas[dxv]
                dy = dy + deltas[dyv]
            r_sq = dx * dx + dy * dy
            valid = (
                q.mask & s_mask[:, None, rows, cols]
                & (r_sq <= radius_sq) & (r_sq > MIN_DISTANCE_SQ)
            )
            s_planes = tuple(a[:, None, rows, cols] for a in s_planes_all)
            outs = term_fn(dx, dy, r_sq, torch.sqrt(r_sq), scalars,
                           q_planes, s_planes)
            for sp in range(ps):
                # where, not a multiply: invalid candidates may hold inf/NaN
                accs = [a + torch.where(valid[sp], o[sp], 0.0)
                        for a, o in zip(accs, outs)]
    outs = accs if post_fn is None else post_fn(accs, tuple(_planes(post_planes)), scalars)
    out = torch.stack(list(outs))
    return torch.where(q.mask[None], out, 0.0)


def launch(form: PairForm, q: PlaneGeom, s: PlaneGeom, consts: cuda_build.PairConsts,
           q_vals, s_vals, scalars, post_planes, tile, s_halo=()) -> torch.Tensor:
    """Launch K1's instantiation of `form` on CUDA tensors with the launch
    shape `tile` = (TY, TX, threads); returns (n_out, P, ny, nx). A source
    geometry with a halo launches the halo form, `s_halo` its value rows.
    Counts nothing: `pair_reduce` is the solvers' entry (tools/tile_sweep.py
    times other shapes through this)."""
    device = q.pos.device
    p, ny, nx = q.mask.shape
    ps = s.mask.shape[0]
    for t, shape, dtype, what in (
            (q.pos, (2, p, ny, nx), q.pos.dtype, "query positions"),
            (q.mask, (p, ny, nx), torch.bool, "query mask"),
            (s.pos, (2, ps, ny, nx), q.pos.dtype, "source positions"),
            (s.mask, (ps, ny, nx), torch.bool, "source mask")):
        cuda_build.check_tensor(t, device, shape, dtype, f"pair_reduce: {what}")
    if len(scalars) > 1:
        raise ValueError("pair_reduce: the CUDA forms take at most one scalar")
    s_ptrs = cuda_build.plane_pointers(s_vals, device, ps, ny, nx,
                                       "pair_reduce: source value")
    ptrs = (
        cuda_build.plane_pointers(q_vals, device, p, ny, nx, "pair_reduce: query value")
        + s_ptrs
        + cuda_build.plane_pointers(post_planes, device, p, ny, nx, "pair_reduce: post plane")
    )
    ty, tx, threads = tile
    smem = smem_bytes(ty, tx, p, ps, len(s_ptrs), q.rebase_cell is not None)
    out = torch.empty((form.n_out, p, ny, nx), dtype=torch.float32, device=device)
    # the bf16 launchers take the f32 rebase cell before the constants, the
    # halo launchers the halo rows of positions, mask and source values
    name, cell = (form.name, ()) if q.rebase_cell is None else (
        f"{form.name}_bf16", (f32_scalar(q.rebase_cell),))
    halo = ()
    val_rows = _source_halo(s, s_vals, s_halo)
    if val_rows is not None:
        h_pos, h_mask = s.halo.planes
        cuda_build.check_tensor(h_pos, device, (2, ps, 2, nx), q.pos.dtype,
                                "pair_reduce: halo positions")
        cuda_build.check_tensor(h_mask, device, (ps, 2, nx), torch.bool,
                                "pair_reduce: halo mask")
        h_ptrs = cuda_build.plane_pointers(val_rows, device, ps, 2, nx,
                                           "pair_reduce: halo value")
        name += "_halo"
        halo = (h_pos.data_ptr(), h_mask.data_ptr(), cuda_build.pointer_array(h_ptrs))
    fn = getattr(cuda_build.library(), f"pair_reduce_{name}")
    err = fn(
        q.pos.data_ptr(), q.mask.data_ptr(), s.pos.data_ptr(), s.mask.data_ptr(),
        cuda_build.pointer_array(ptrs), len(ptrs), out.data_ptr(),
        p, ps, ny, nx, ty, tx, threads, smem, float(scalars[0]) if scalars else 0.0,
        *cell, *halo, consts, torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(err, f"pair_reduce_{name}")
    return out


def pair_reduce(form: PairForm, q: PlaneGeom, s: PlaneGeom,
                consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                scalars=(), post_planes=(), s_halo=()) -> torch.Tensor:
    """Run one K1 call form; returns the stacked (n_out, P, ny, nx) output.
    `consts.radius_sq` is the pair cutoff for both routes. The geometries'
    dtype picks the operand mode (float32, or bfloat16 from
    `planes.plane_geom`); value and post planes are f32 in both. A source
    geometry with a halo runs the halo form, `s_halo` holding the rows of
    each source value plane (module docstring). The launch shape is
    `tile_shape`'s."""
    device = q.pos.device
    _operand_mode(q, s)
    if device.type == "cpu":
        return pair_reduce_ref(
            form.term_fn, form.n_out, q, s, consts.radius_sq, q_vals=q_vals,
            s_vals=s_vals, scalars=scalars, post_fn=form.post_fn,
            post_planes=post_planes, n_acc=form.n_acc, s_halo=s_halo,
        )
    if device.type != "cuda":
        raise ValueError(f"pair_reduce: unsupported device {device}")
    bf16 = q.rebase_cell is not None
    p, ny, nx = q.mask.shape
    tile = tile_shape(p, s.mask.shape[0], len(_planes(s_vals)), bf16, ny, nx)[:3]
    out = launch(form, q, s, consts, q_vals, s_vals, scalars, post_planes, tile, s_halo)
    LAUNCHES[form.name + ("_bf16" if bf16 else "")
             + ("_halo" if s.halo is not None else "")] += 1
    return out
