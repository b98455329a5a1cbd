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

bf16 math mode (`rebase`, a `Rebase`: `rebase_of(grid)` on a grid with
`pair_dtype="bfloat16"`): the contract of the JAX XLA
`dense_grid.pair_reduce` at a bf16 grid (`relative=True`,
yasph2d_tpu/ops/dense_grid.py:843-887), which the JAX padded solvers run
there. Operation by operation, as `jax.make_jaxpr` of that pass shows it for
each closure of the padded solvers (DFSPH ctx to the fluid and the walls,
div, corr, visc and visc with physical viscosity; WCSPH density, stat,
forces and forces with physical viscosity):
- rebase, f32: centre = (i + 0.5 [+ row0]) * h + origin per cell column and
  (global) row, pos - centre, then cast to bf16; query and source positions
  alike, a shard's halo rows on their own (global) rows;
- query values, source values and the scalar (dt): cast f32 -> bf16;
- ri_to_rj = rel_j - rel_i (bf16), + the view's offset ((dxv-1) h, (dyv-1)
  h) as a bf16 array (h rounded to f32, then bf16) (bf16);
- r^2 = x*x, y*y (bf16), summed in f32 (jnp.sum upcasts), cast to bf16;
  the compares r^2 <= h^2 and r^2 > 1e-10 in bf16 (both Python floats,
  rounded to bf16); r = sqrt(r^2) (bf16);
- every operation of the term in bf16, every Python-float constant rounded
  to bf16 (jnp.sum over a vector's two components in f32, then bf16, as
  r^2); except PhysicalViscosityModel's f32(mu m), an f32 array: the
  laplacian is bf16, then f32(mu m) * lap, / rho_j and * (v_j - v_i) are
  f32, and WCSPH's pressure term (bf16) + that viscosity term adds in f32;
- where(valid, term, 0) in the term's dtype, cast to f32, summed in f32.
Each bf16 operation is its f32 result rounded to bf16 (round to nearest
even): in the twin (`bf16_terms`, on f32 tensors through `_rd`) literally, in
the kernel (csrc/pair_terms.cuh Bf16Math) as Hopper's own bf16 instructions,
which give those bits (tests/test_torch_bf16_rounding.py), so that per pair
both compute the same values. The kernel stages the tile in bf16
(`smem_bytes(..., bf16=True)`).
The sums are f32 in K5's order: per view over Ps, then the views; the JAX
pass sums one 9 Ps axis. The constants come rounded (`bf16_consts`), the
scalar is rounded here. The CUDA forms of this mode launch and count under
`<form>_bf16` and `<form>_bf16_halo`.

Loop launches (`loop_launcher`; K3's in ops/sm_pair_reduce.py): a DFSPH
pressure loop whose exit test runs on the device (ops/pressure_glue.py)
launches its div and corr passes once an iteration on the same operands,
into an output of its own. The launcher checks them and builds the launch's
arguments once and returns a function of the iteration i that launches it
gated on the loop's state: it writes nothing unless i <= state[0]. On CPU
tensors it runs the twin into the output under the same condition.
"""

from typing import Callable, NamedTuple, Optional

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ, f32_scalar
from .pair_reduce import PairForm
from .planes import Halo, centre_coords

# kernel launches per call form (bf16 mode under "<form>_bf16", halo forms
# under "<form>_halo" / "<form>_bf16_halo"), counted where the wrapper launches
LAUNCHES = {f"{form}{suffix}": 0 for suffix in ("", "_bf16", "_halo", "_bf16_halo")
            for form in cuda_build.TILE_PAIR_FORMS}

# (TY, TX, threads) of a launch, both sides powers of two, at most 256 threads
# (csrc/tile_pair_reduce.cu K5_MAX_THREADS): tools/tile_sweep.py --kernel k5
# on the 100k padded states, and for K3 --kernel k3 (within 1% of the best
# shape on every loop form; so it is in the bf16 mode, --kinds
# dfsph_padded_k5_bf16,wcsph_padded_k5_bf16); tile_shape halves it where it
# does not fit
TILE = (8, 8, 256)
MAX_ROUND = 8192  # query slots whose live list a block holds at once
SMEM_LIMIT = cuda_build.SMEM_LIMIT


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


class Rebase(NamedTuple):
    """K5's bf16 math mode: the geometry of the cell centres that positions
    are rebased onto (module docstring)."""

    cell: float  # the cell size h
    origin: tuple  # (x0, y0)
    row0: int = 0  # the grid's first global cell row (a shard's)


def rebase_of(grid, row0: int = 0) -> Optional[Rebase]:
    """The math mode of `grid`'s pair passes: a Rebase for pair_dtype
    "bfloat16", None (f32) otherwise; `row0` a shard's first global row."""
    if grid.pair_dtype != "bfloat16":
        return None
    return Rebase(float(grid.cell_size), tuple(float(o) for o in grid.origin), row0)


def _rd(x: torch.Tensor) -> torch.Tensor:
    """One bf16 operation's result: the f32 result rounded to bf16 (nearest
    even), held in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_float(x: float) -> float:
    """`x` rounded to f32, then to bf16: a weakly typed Python float in a bf16
    JAX operation."""
    return float(torch.tensor(x, dtype=torch.float32).to(torch.bfloat16))


def bf16_consts(consts: cuda_build.PairConsts) -> cuda_build.PairConsts:
    """The constants of the bf16 mode: each rounded to bf16 as the JAX pass
    rounds its Python floats, except f32(mu m), an f32 array in the JAX
    physical viscosity model."""
    return cuda_build.PairConsts(**{
        name: getattr(consts, name) if name == "mu_m" else bf16_float(getattr(consts, name))
        for name, _ in consts._fields_})


def bf16_terms(name: str, c: cuda_build.PairConsts) -> Callable:
    """The twin's per-pair terms of K5's form `name` in the bf16 mode, with the
    bf16 constants `c`: the operations of the JAX closure at a bf16 grid
    (module docstring), each rounded by `_rd`, as csrc/pair_terms.cuh
    computes them with Bf16Math. Operands are bf16 values held in f32."""
    phys = name.endswith("_phys")

    def wendland(r):  # (W, grad coefficient)
        q = torch.clamp(_rd(r * c.w_h_inv), max=1.0)
        omq = _rd(1.0 - q)
        omq_sq = _rd(omq * omq)
        w = _rd(_rd(_rd(c.w_norm * omq_sq) * omq_sq) * _rd(q + 0.25))
        return w, _rd(_rd(_rd(c.w_norm_grad * omq) * omq) * omq)

    def poly6(r_sq, hsq, norm):
        dsq = torch.clamp(_rd(hsq - r_sq), min=0.0)
        return _rd(_rd(_rd(norm * dsq) * dsq) * dsq)

    def spiky(r):  # (W, grad coefficient)
        hsubr = torch.clamp(_rd(c.sp_h - r), min=0.0)
        w = _rd(_rd(_rd(c.sp_norm * hsubr) * hsubr) * hsubr)
        gc = _rd(_rd(_rd(c.sp_norm_grad * hsubr) * hsubr) / _rd(r + bf16_float(1.0e-10)))
        return w, gc

    def visc(r_sq, r, rho_j, dt, dv):  # the viscosity term c (v_j - v_i)
        if phys:  # f32 from the f32 array f32(mu m) on
            return (c.mu_m * _rd(c.vl_norm * _rd(c.vl_h - r))) / rho_j * dv
        vc = _rd(_rd(c.xsph_coef * poly6(r_sq, c.p6_hsq, c.p6_norm)) / _rd(rho_j * dt))
        return _rd(vc * dv)

    def ctx(dx, dy, r_sq, r, scalars, q, s):
        w, gc = wendland(r)
        gx = _rd(_rd(gc * dx) * c.mass)
        gy = _rd(_rd(gc * dy) * c.mass)
        return (w, gx, gy, _rd(_rd(gx * gx) + _rd(gy * gy)), torch.ones_like(r_sq))

    def div(dx, dy, r_sq, r, scalars, q, s):
        gc = wendland(r)[1]
        return (_rd(_rd(_rd(q[0] - s[0]) * _rd(gc * dx))
                    + _rd(_rd(q[1] - s[1]) * _rd(gc * dy))),)

    def corr(dx, dy, r_sq, r, scalars, q, s):
        kk = _rd(q[0] + s[0])
        gc = wendland(r)[1]
        return (_rd(kk * _rd(gc * dx)), _rd(kk * _rd(gc * dy)))

    def dfsph_visc(dx, dy, r_sq, r, scalars, q, s):
        return tuple(visc(r_sq, r, s[2], scalars[0], _rd(s[k] - q[k])) for k in (0, 1))

    def density(dx, dy, r_sq, r, scalars, q, s):
        return (poly6(r_sq, c.d6_hsq, c.d6_norm),)

    def stat(dx, dy, r_sq, r, scalars, q, s):
        cf = _rd(_rd(-c.bff * spiky(r)[0]) / r_sq)
        return (poly6(r_sq, c.d6_hsq, c.d6_norm), _rd(cf * dx), _rd(cf * dy))

    def forces(dx, dy, r_sq, r, scalars, q, s):
        p_i, rho_i, vx_i, vy_i = q
        p_j, rho_j, vx_j, vy_j = s
        coef = _rd(_rd(-c.mass * _rd(p_i + p_j)) / _rd(_rd(2.0 * rho_i) * rho_j))
        gc = spiky(r)[1]
        out = []
        for d, v_i, v_j in ((dx, vx_i, vx_j), (dy, vy_i, vy_j)):
            f = _rd(coef * _rd(gc * d)) + visc(r_sq, r, rho_j, scalars[0], _rd(v_j - v_i))
            out.append(f if phys else _rd(f))  # bf16 + f32 adds in f32
        return tuple(out)

    return dict(dfsph_ctx=ctx, dfsph_div=div, dfsph_corr=corr, dfsph_visc=dfsph_visc,
                wcsph_density=density, wcsph_stat=stat,
                wcsph_forces=forces)[name.removesuffix("_phys")]


def bf16_form(form: PairForm, consts: cuda_build.PairConsts) -> PairForm:
    """`form` in the bf16 mode: its twin's terms `bf16_terms` with the bf16
    constants `consts` (`bf16_consts`); the CUDA form keeps its name."""
    return PairForm(form.name, form.n_out, bf16_terms(form.name, consts), bf16=True)


def require_mode(kernel: str, form: PairForm, rebase: Optional[Rebase]):
    """Raise unless a bf16 form comes with a rebase and an f32 form without:
    the terms and constants are the mode's."""
    if form.bf16 != (rebase is not None):
        raise ValueError(f"{kernel}: form {form.name} is {'bf16' if form.bf16 else 'f32'} "
                         f"math, called {'with' if rebase is not None else 'without'} a rebase")


def _centres(rebase: Rebase, rows: int, cols: int, row_lo: int, col_lo: int,
             device) -> torch.Tensor:
    """(rows, cols, 1, 2) f32 centres (planes.centre_coords) of the cells from
    local row `row_lo` and column `col_lo` on."""
    cx, cy = centre_coords(rebase.cell, rebase.origin, cols, rows, rebase.row0 + row_lo,
                           device, col_lo)
    return torch.stack([cx.expand(rows, cols), cy[:, None].expand(rows, cols)],
                       dim=-1)[:, :, None]


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
                           halo: Optional[Halo] = None, rebase: Optional[Rebase] = None):
    """Plain PyTorch twin of K5: nine shifted views of the one-cell-padded
    source space; each view evaluates the terms of all Ps source slots at once
    ((ny, nx, P, Ps) candidates), sums them over Ps with torch.sum, and the
    view sums are added in (dy, dx) order. Returns (ny, nx, P, n_out). With a
    `halo` the ring's rows -1 and ny are its rows; with a `rebase` the bf16
    math mode (module docstring), `term_fn` its terms (`bf16_terms`) and
    `radius_sq` rounded to bf16."""
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
    q_comps = tuple(_comps(q_vals))
    rd = min_sq = None
    if rebase is not None:  # positions onto their cells' centres, values and scalars
        rd, min_sq = _rd, bf16_float(MIN_DISTANCE_SQ)  # to bf16
        q_pos = _rd(q_pos - _centres(rebase, ny, nx, 0, 0, q_pos.device))
        s_pos = _rd(s_pos - _centres(rebase, ny + 2, nx + 2, -1, -1, q_pos.device))
        q_comps = tuple(map(_rd, q_comps))
        s_comps = list(map(_rd, s_comps))
        scalars = tuple(bf16_float(x) for x in scalars)
        h = bf16_float(rebase.cell)
        deltas = (-h, 0.0, h)
    qx, qy = q_pos[..., 0, None], q_pos[..., 1, None]  # (ny, nx, P, 1)
    q_comps = tuple(c[..., None] for c in q_comps)
    q_live = q_mask[..., None]
    radius_sq = torch.tensor(radius_sq, dtype=q_pos.dtype, device=q_pos.device)
    accs = None
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            dx = s_pos[rows, cols, None, :, 0] - qx
            dy = s_pos[rows, cols, None, :, 1] - qy
            if rd is None:
                r_sq = dx * dx + dy * dy
                r_min = MIN_DISTANCE_SQ
            else:  # each operation rounded, the views' centre offsets added
                dx, dy = rd(rd(dx) + deltas[dxv]), rd(rd(dy) + deltas[dyv])
                r_sq = rd(rd(dx * dx) + rd(dy * dy))
                r_min = min_sq
            valid = (
                q_live & s_mask[rows, cols, None, :]
                & (r_sq <= radius_sq) & (r_sq > r_min)
            )
            s_planes = tuple(c[rows, cols, None, :] for c in s_comps)
            r = torch.sqrt(r_sq) if rd is None else rd(torch.sqrt(r_sq))
            outs = term_fn(dx, dy, r_sq, r, scalars, q_comps, s_planes)
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


def smem_bytes(ty: int, tx: int, p: int, ps: int, n_source_comps: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of one K5 block (csrc/tile_pair_reduce.cu
    TileSmem): the haloed source tile's positions (float2, or __nv_bfloat162
    in the bf16 mode) and source values (4 B each, or 2 B), its live words
    (ceil(Ps / 32) a cell), the round's live list (uint16) and 32 warp
    counts."""
    hc = (ty + 2) * (tx + 2)
    pos, val = (4, 2) if bf16 else (8, 4)
    return (_align16(hc * ps * pos) + _align16(hc * ps * val * n_source_comps)
            + _align16(hc * -(-ps // 32) * 4) + _align16(query_round(ty, tx, p) * 2) + 32 * 4)


def tile_shape(p: int, ps: int, n_source_comps: int, bf16: bool = False) -> tuple:
    """(TY, TX, threads) of a launch: TILE, halved (the longer side, TY on a
    tie) until its block fits in the shared memory of one block (`bf16`: the
    bf16 mode's staging); raises if not even a 1 x 1 tile fits."""
    ty, tx, threads = TILE
    while smem_bytes(ty, tx, p, ps, n_source_comps, bf16) > SMEM_LIMIT:
        if ty == tx == 1:
            raise ValueError(
                f"pallas_pair_reduce: a 1 x 1 cell tile with Ps = {ps} source slots and "
                f"{n_source_comps} source values needs "
                f"{smem_bytes(1, 1, p, ps, n_source_comps, bf16)} bytes of shared memory; "
                f"a block has {SMEM_LIMIT}")
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


def tile_call(kernel: str, form: PairForm, q_pos, q_mask, s_pos, s_mask,
              consts: cuda_build.PairConsts, q_vals, s_vals, scalars, tile, out,
              halo: Optional[Halo] = None, rebase: Optional[Rebase] = None) -> tuple:
    """Check a launch of `kernel`'s instantiation of `form` (csrc/
    tile_pair_reduce.cu: `tile_pair_reduce`, K5's sum order, or
    `sm_pair_reduce`, K3's) on CUDA tensors with the launch shape `tile` =
    (TY, TX, threads) into `out` (ny, nx, P, n_out), and return (its
    launcher's name, the arguments before the gate, those after it). A
    `halo` (K5 only) is the form's halo instantiation
    (csrc/tile_pair_reduce_halo.cu), a `rebase` (K5 only) its bf16 math
    mode."""
    require_mode(kernel, form, rebase)
    (ny, nx, p, ps), ptrs, strides, scalar = slot_operands(
        kernel, q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars)
    ty, tx, threads = tile
    n_sv = len(_comps(s_vals))
    cuda_build.check_tensor(out, q_pos.device, (ny, nx, p, form.n_out), torch.float32,
                            f"{kernel}: output")
    name, extra = f"{kernel}_{form.name}", ()
    if (halo is not None or rebase is not None) and kernel != "tile_pair_reduce":
        raise ValueError(f"{kernel}: no halo form and no bf16 mode (K5's sum order only)")
    if rebase is not None:  # after the scalar: the rebase's origin, cell, row0
        name += "_bf16"
        scalar = bf16_float(scalar)
        extra = (f32_scalar(rebase.origin[0]), f32_scalar(rebase.origin[1]),
                 f32_scalar(rebase.cell), rebase.row0)
    if halo is not None:
        h_pos, h_mask, h_ptrs = halo_operands(halo, s_vals, q_pos.device, nx, ps)
        name += "_halo"
        extra += (h_pos, h_mask, cuda_build.pointer_array(h_ptrs))
    return name, (
        q_pos.data_ptr(), q_mask.data_ptr(), s_pos.data_ptr(), s_mask.data_ptr(),
        cuda_build.pointer_array(ptrs), cuda_build.int_array(strides), len(ptrs),
        out.data_ptr(), p, ps, ny, nx, ty, tx, threads, query_round(ty, tx, p),
        smem_bytes(ty, tx, p, ps, n_sv, rebase is not None), scalar, *extra), (
        consts, torch.cuda.current_stream(q_pos.device).cuda_stream)


def tile_launch(kernel: str, form: PairForm, q_pos, q_mask, s_pos, s_mask,
                consts: cuda_build.PairConsts, q_vals, s_vals, scalars, tile,
                halo: Optional[Halo] = None, rebase: Optional[Rebase] = None
                ) -> torch.Tensor:
    """Launch `kernel`'s instantiation of `form` (`tile_call`) without a
    gate; returns (ny, nx, P, n_out). Counts nothing."""
    out = torch.empty(q_mask.shape + (form.n_out,), dtype=torch.float32, device=q_pos.device)
    name, head, tail = tile_call(kernel, form, q_pos, q_mask, s_pos, s_mask, consts, q_vals,
                                 s_vals, scalars, tile, out, halo, rebase)
    cuda_build.check(getattr(cuda_build.library(), name)(*head, None, 0, *tail), name)
    return out


def gated_tile_launcher(kernel: str, form: PairForm, q_pos, q_mask, s_pos, s_mask,
                        consts: cuda_build.PairConsts, q_vals, s_vals, out, state,
                        rebase: Optional[Rebase], twin: Callable, count: Callable) -> Callable:
    """A function of a loop's iteration i that launches `kernel`'s `form`
    (`tile_call`, at `tile_shape`'s launch shape) into `out`, gated on the
    loop's int32 `state` (module docstring) and counted by `count()`; on
    CPU tensors `twin()` computes the pass."""
    if q_pos.device.type == "cpu":
        def launch(i: int):
            if i <= int(state[0]):
                out.copy_(twin())
        return launch
    cuda_build.check_tensor(state, q_pos.device, (2,), torch.int32, f"{kernel}: loop state")
    tile = tile_shape(q_mask.shape[2], s_mask.shape[2], len(_comps(s_vals)), rebase is not None)
    name, head, tail = tile_call(kernel, form, q_pos, q_mask, s_pos, s_mask, consts, q_vals,
                                 s_vals, (), tile, out, rebase=rebase)
    fn, head = getattr(cuda_build.library(), name), head + (state.data_ptr(),)

    def launch(i: int, _out=out):
        cuda_build.check(fn(*head, i, *tail), name)
        count()
    return launch


def launch(form: PairForm, q_pos, q_mask, s_pos, s_mask, consts: cuda_build.PairConsts,
           q_vals, s_vals, scalars, tile, halo: Optional[Halo] = None,
           rebase: Optional[Rebase] = None) -> torch.Tensor:
    """Launch K5's instantiation of `form` (its halo form with a `halo`, its
    bf16 mode with a `rebase`) on CUDA tensors with the launch shape `tile` =
    (TY, TX, threads); returns (ny, nx, P, n_out). Counts nothing:
    `pallas_pair_reduce` is the solvers' entry (tools/tile_sweep.py times
    other shapes through this)."""
    return tile_launch("tile_pair_reduce", form, q_pos, q_mask, s_pos, s_mask, consts,
                       q_vals, s_vals, scalars, tile, halo, rebase)


def loop_launcher(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                  consts: cuda_build.PairConsts, q_vals, s_vals, out, state,
                  rebase: Optional[Rebase] = None) -> Callable:
    """K5's `form` (one device, no scalar) into `out`, gated on a pressure
    loop's `state`, as a function of the iteration (module docstring);
    counted as `pallas_pair_reduce` counts."""
    require_mode("pallas_pair_reduce", form, rebase)
    key = form.name + ("" if rebase is None else "_bf16")

    def twin():
        return pallas_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos, s_mask,
                                      consts.radius_sq, q_vals=q_vals, s_vals=s_vals,
                                      rebase=rebase)

    def count():
        LAUNCHES[key] += 1
    return gated_tile_launcher("tile_pair_reduce", form, q_pos, q_mask, s_pos, s_mask, consts,
                               q_vals, s_vals, out, state, rebase, twin, count)


def pallas_pair_reduce(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                       consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                       scalars=(), halo: Optional[Halo] = None,
                       rebase: Optional[Rebase] = None) -> torch.Tensor:
    """Run one K5 call form; returns (ny, nx, P, n_out). `consts.radius_sq` is
    the pair cutoff for both routes; the launch shape is `tile_shape`'s, with
    or without a `halo` (the source's rows -1 and ny) or a `rebase` (the bf16
    math mode: `form` from `bf16_form`, `consts` from `bf16_consts`; module
    docstring)."""
    if form.post_fn is not None:
        raise ValueError("pallas_pair_reduce: K5 forms have no epilogue")
    require_mode("pallas_pair_reduce", form, rebase)
    device = q_pos.device
    if device.type == "cpu":
        return pallas_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos,
                                      s_mask, consts.radius_sq, q_vals=q_vals,
                                      s_vals=s_vals, scalars=scalars, halo=halo,
                                      rebase=rebase)
    if device.type != "cuda":
        raise ValueError(f"pallas_pair_reduce: unsupported device {device}")
    tile = tile_shape(q_mask.shape[2], s_mask.shape[2], len(_comps(s_vals)), rebase is not None)
    out = launch(form, q_pos, q_mask, s_pos, s_mask, consts, q_vals, s_vals, scalars,
                 tile, halo, rebase)
    LAUNCHES[form.name + ("" if rebase is None else "_bf16")
             + ("" if halo is None else "_halo")] += 1
    return out
