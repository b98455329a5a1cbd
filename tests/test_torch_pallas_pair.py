"""K5 (the gen-1 pair reduction on cell tiles): the port's plain twin in its
seven call forms (the DFSPH padded step's four, the WCSPH padded step's three)
against the JAX pallas_pair_reduce in interpret mode on the CPU (as
tests/test_pallas_pair.py runs it) and against the JAX XLA
dense_grid.pair_reduce, of which it is the drop-in. The setup is that of
tests/test_pallas_pair.py:23-41 (500 random particles on a 20 x 10 grid, P = 8,
row blocks of 7 that leave an uneven last block), plus a boundary source space
with Ps = 3 != P for the two boundary passes.

Tolerance on live slots: rtol 1e-4, and atol 1e-4 in units of the output's
largest magnitude: the tolerance tests/test_pallas_pair.py states for two
summation orders (the twin sums each view's Ps candidates with torch.sum, the
Pallas kernel with jnp.sum, the XLA path over one 9P axis), scaled because
the gradient sums at h = 0.1 reach 1e4."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JDFSPH
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JWCSPH
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.dense_grid import build_slot_grid, cell_keys, pad_to_slots
from yasph2d_tpu.ops.dense_grid import pair_reduce as j_xla_pair_reduce
from yasph2d_tpu.ops.pallas_pair import pallas_pair_reduce as j_pallas_pair_reduce
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TDFSPH
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TWCSPH
from yasph2d_tpu_torch.ops import pallas_pair as tpp
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.world import FluidProperties as TProps

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-4
NY, NX, P, PB = 20, 10, 8, 3
BLOCK_ROWS = 7  # 20 % 7 != 0: an uneven last row block
DT = np.float32(1.0 / 2700.0)
FORMS = ["dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc",
         "wcsph_density", "wcsph_stat", "wcsph_forces"]
# (form, boundary source): every form against the fluid, the two boundary
# passes also against the boundary space
CASES = [(f, False) for f in FORMS] + [("dfsph_ctx", True), ("wcsph_stat", True)]
IDS = FORMS + ["dfsph_ctx[boundary]", "wcsph_stat[boundary]"]


@functools.lru_cache(maxsize=None)
def solvers():
    """Both packages' DFSPH and WCSPH padded solvers on the K5 route (the JAX
    ones on their XLA route: use_pallas and use_pallas_slotmajor off)."""
    props = dict(smoothing_factor=2.0, particle_density=400.0, fluid_density=100.0)
    jp, tp = JProps(**props), TProps(**props)
    h = jp.smoothing_length
    base = dict(cell_size=h, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    jgrid, tgrid = JGrid(**base, row_block=6), TGrid(**base)
    common = dict(step_config=JFixed(1.0 / 3000.0), grid=jgrid, properties=jp,
                  viscosity_model=JXSPH(h))
    jd, jw = JDFSPH(**common), JWCSPH(**common)
    common = dict(step_config=TFixed(1.0 / 3000.0), grid=tgrid, properties=tp,
                  viscosity_model=TXSPH(h))
    td, tw = TDFSPH(**common), TWCSPH(**common)
    forms = {f.name: f for f in td._padded_forms}
    forms.update({f.name: f for f in tw._forms})
    return h, jgrid, jd, jw, td, tw, forms


def jax_closures(jd, jw):
    """The JAX padded solvers' XLA closures, op for op, with the port's output
    order: DFSPH terms/div/corr/visc (models/dfsph_dense.py:269-276, 401-403,
    451-453, 484-487), WCSPH density/stat_terms/dyn_forces
    (models/wcsph_dense.py:141, 144-150, 189-197)."""
    m = float(jd.properties.particle_mass)
    k, dk, pk = jd.kernel, jw.density_kernel, jw.pressure_kernel
    visc = jd.viscosity_model

    def ctx(ri_to_rj, r_sq, r):
        mgrad = k.gradient(ri_to_rj, r_sq, r) * m
        return (k.evaluate(r_sq, r), mgrad, jnp.sum(mgrad * mgrad, axis=-1),
                jnp.ones_like(r_sq))

    def div(ri_to_rj, r_sq, r, v_i, v_j):
        return jnp.sum((v_i - v_j) * k.gradient(ri_to_rj, r_sq, r), axis=-1)

    def corr(ri_to_rj, r_sq, r, k_i, k_j):
        return (k_i + k_j)[..., None] * k.gradient(ri_to_rj, r_sq, r)

    def visc_fn(ri_to_rj, r_sq, r, dt_s, v_i, v_j, rho_j):
        return visc.compute_viscous_acceleration(dt_s, r_sq, r, m, rho_j, v_j - v_i)

    def density(ri_to_rj, r_sq, r):
        return dk.evaluate(r_sq, r)

    def stat(ri_to_rj, r_sq, r):
        c = -jw.boundary_force_factor * pk.evaluate(r_sq, r) / r_sq
        return (dk.evaluate(r_sq, r), c[..., None] * ri_to_rj)

    def forces(ri_to_rj, r_sq, r, dt_s, p_i, rho_i, v_i, p_j, rho_j, v_j):
        coef = -m * (p_i + p_j) / (2.0 * rho_i * rho_j)
        f = coef[..., None] * pk.gradient(ri_to_rj, r_sq, r)
        return f + visc.compute_viscous_acceleration(dt_s, r_sq, r, m, rho_j, v_j - v_i)

    return dict(dfsph_ctx=ctx, dfsph_div=div, dfsph_corr=corr, dfsph_visc=visc_fn,
                wcsph_density=density, wcsph_stat=stat, wcsph_forces=forces)


def stack_outputs(out) -> np.ndarray:
    """A JAX pytree of (ny, nx, P[, 2]) leaves, in order, as (ny, nx, P, n_out)."""
    leaves = jax.tree_util.tree_leaves(out)
    return np.concatenate([np.asarray(a)[..., None] if a.ndim == 3 else np.asarray(a)
                           for a in leaves], axis=-1)


class Case:
    """tests/test_pallas_pair.py's setup (random positions over the grid, cell
    sort, slot grid) for the fluid, and a 60-particle boundary space."""

    def __init__(self, seed):
        h, self.jgrid, self.jd, self.jw, self.td, self.tw, self.forms = solvers()
        self.closures = jax_closures(self.jd, self.jw)
        rng = np.random.default_rng(seed)

        def slot_space(n, occupancy):
            grid = dataclasses.replace(self.jgrid, occupancy=occupancy)
            pos = jnp.asarray((rng.random((n, 2)) * [NX * h, NY * h]).astype(np.float32))
            keys = cell_keys(pos, grid)
            order = jnp.argsort(keys)
            slots = build_slot_grid(keys[order], grid)
            return (np.asarray(pad_to_slots(pos[order], slots, grid)),
                    np.asarray(slots.slot_mask).reshape(NY, NX, occupancy))

        self.pos, self.mask = slot_space(500, P)
        self.bpos, self.bmask = slot_space(60, PB)
        f = lambda *s: rng.random((NY, NX, P) + s).astype(np.float32)  # noqa: E731
        self.v = rng.standard_normal((NY, NX, P, 2)).astype(np.float32)
        self.k = 50.0 * (f() - 0.5)
        self.pres = 500.0 * f()
        # dead slots hold rho = 0: the XSPH term divides by it (NaN hygiene)
        self.rho = np.where(self.mask, 100.0 + 30.0 * f(), 0.0).astype(np.float32)

    def operands(self, form, boundary):
        """(source pos, source mask, q_vals, s_vals, scalars) as numpy."""
        spos, smask = (self.bpos, self.bmask) if boundary else (self.pos, self.mask)
        vals = (self.pres, self.rho, self.v)
        q_vals, s_vals, scalars = {
            "dfsph_div": ((self.v,), (self.v,), ()),
            "dfsph_corr": ((self.k,), (self.k,), ()),
            "dfsph_visc": ((self.v,), (self.v, self.rho), (DT,)),
            "wcsph_forces": (vals, vals, (DT,)),
        }.get(form, ((), (), ()))
        return spos, smask, q_vals, s_vals, scalars

    def jax(self, form, boundary, pallas):
        spos, smask, qv, sv, sc = self.operands(form, boundary)
        j = jnp.asarray
        kw = dict(source_values=tuple(map(j, sv)), query_values=tuple(map(j, qv)),
                  scalar_args=tuple(jnp.float32(s) for s in sc))
        if pallas:
            out = j_pallas_pair_reduce(self.closures[form], j(self.pos), j(self.mask),
                                       j(spos), j(smask), self.jgrid,
                                       block_rows=BLOCK_ROWS, interpret=True, **kw)
        else:
            out = j_xla_pair_reduce(self.closures[form], j(self.pos), j(self.mask),
                                    j(spos), j(smask), self.jgrid, **kw)
        return stack_outputs(out)

    def port(self, form, boundary):
        spos, smask, qv, sv, sc = self.operands(form, boundary)
        t = torch.as_tensor
        return tpp.pallas_pair_reduce(
            self.forms[form], t(self.pos), t(self.mask), t(spos), t(smask),
            self.td._consts, q_vals=tuple(map(t, qv)), s_vals=tuple(map(t, sv)),
            scalars=tuple(float(s) for s in sc)).numpy()


def assert_live_close(out_t, ref, mask, what):
    assert out_t.shape == ref.shape, (out_t.shape, ref.shape)
    for k in range(ref.shape[-1]):
        a, b = out_t[..., k][mask], ref[..., k][mask]
        atol = ATOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=f"{what} {k}")
    assert np.isfinite(out_t).all()
    assert (out_t[~mask] == 0).all()  # dead query slots


@pytest.fixture(scope="module", params=[0, 3], ids=["seed0", "seed3"])
def case(request):
    return Case(seed=request.param)


@pytest.mark.parametrize("form,boundary", CASES, ids=IDS)
def test_twin_matches_jax_pallas_kernel(case, form, boundary):
    ref = case.jax(form, boundary, pallas=True)
    out = case.port(form, boundary)
    assert case.mask.any() and (~case.mask).any()
    assert_live_close(out, ref, case.mask, form)
    assert np.abs(out).sum() > 0  # the pass did real work


@pytest.mark.parametrize("form,boundary", CASES, ids=IDS)
def test_twin_matches_jax_xla_pair_reduce(case, form, boundary):
    assert_live_close(case.port(form, boundary), case.jax(form, boundary, pallas=False),
                      case.mask, form)


def test_tile_width_fits_shared_memory():
    """The launch's tile is the widest whose query slots take one thread each
    (at most 512) and whose source tile fits in shared memory; a source space
    that cannot fit one column is refused with a message, not shrunk."""
    assert tpp.tile_shape(7, 7, 4) == (8, 8, 448)  # the 100k fluid pass, 4 values
    assert tpp.tile_shape(7, 8, 0) == (8, 8, 448)  # the 100k boundary pass
    assert tpp.tile_shape(3, 2, 0) == (8, 16, 384)
    _, bc, threads = tpp.tile_shape(1, 100, 0)
    assert (tpp.BLOCK_ROWS + 2) * (bc + 2) * 100 * 9 <= tpp.SMEM_LIMIT
    assert (tpp.BLOCK_ROWS + 2) * (2 * bc + 2) * 100 * 9 > tpp.SMEM_LIMIT
    assert threads % 32 == 0 and threads >= tpp.BLOCK_ROWS * bc
    assert tpp.tile_shape(100, 7, 0)[1:] == (1, 512)  # more slots than threads: loops
    with pytest.raises(ValueError, match="shared memory"):
        tpp.tile_shape(7, 5000, 4)


def test_wrapper_dispatch_is_by_device(case):
    """CPU tensors run the twin (no launch counted); a tensor on any other
    non-CUDA device raises, and a form with an epilogue is refused."""
    form = case.forms["wcsph_density"]
    t = torch.as_tensor
    pos, mask = t(case.pos), t(case.mask)
    before = dict(tpp.LAUNCHES)
    ref = tpp.pallas_pair_reduce_ref(form.term_fn, 1, pos, mask, pos, mask,
                                     case.td._consts.radius_sq)
    torch.testing.assert_close(
        tpp.pallas_pair_reduce(form, pos, mask, pos, mask, case.td._consts), ref,
        rtol=0, atol=0)
    assert tpp.LAUNCHES == before
    with pytest.raises(ValueError):
        tpp.pallas_pair_reduce(form, pos.to("meta"), mask.to("meta"), pos.to("meta"),
                               mask.to("meta"), case.td._consts)
    with pytest.raises(ValueError):
        tpp.pallas_pair_reduce(dataclasses.replace(form, post_fn=lambda *a: a),
                               pos, mask, pos, mask, case.td._consts)
