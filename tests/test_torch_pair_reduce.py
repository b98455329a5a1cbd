"""K1 (pair reduction): the port's plain twin in all nine call forms against the
JAX plane solvers' passes (six DFSPH, three WCSPH), whose pf_pair_reduce runs
in interpret mode on the CPU (as tests/test_pallas_plane.py runs it), on random
grids and on distinct query (fluid) / source (boundary) spaces.

Tolerance on live slots: rtol 1e-5, and atol 1e-6 in units of the output
plane's largest magnitude. The accumulation order is the same (dyv, dxv, sp)
on both sides, but XLA contracts multiply-adds where PyTorch rounds each op,
so single terms differ by an ulp; where terms of both signs cancel (gradient
sums), that ulp is large against the small result but not against the plane's
scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_plane import (
    BoundaryPlanes as JBoundaryPlanes,
    DFSPHPlaneSolver as JSolver,
    PlaneCtx as JCtx,
)
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_plane import WCSPHPlaneSolver as JWSolver
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.pallas_slotmajor import (
    pass_flags,
    pf_build_geom,
    pf_pair_reduce,
    to_planes as j_to_planes,
)
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.dfsph_plane import (
    BoundaryPlanes as TBoundaryPlanes,
    DFSPHPlaneSolver as TSolver,
    PlaneCtx as TCtx,
)
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_plane import WCSPHPlaneSolver as TWSolver
from yasph2d_tpu_torch.ops import pair_reduce as tpr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.planes import PlaneGeom, to_planes
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.world import FluidProperties as TProps

torch.set_num_threads(1)

BR = 4
RTOL, ATOL = 1e-5, 1e-6
FORMS = ["ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v",
         "wcsph_density", "wcsph_stat", "wcsph_forces"]


NY, NX, P, PB = 11, 17, 3, 2


@functools.lru_cache(maxsize=None)
def solvers():
    """Both solvers on one random-grid configuration, and the JAX passes jitted
    once for every seed (the interpret-mode compiles dominate the test time)."""
    props = dict(smoothing_factor=1.0, particle_density=60.0, fluid_density=100.0)
    jp, tp = JProps(**props), TProps(**props)
    h = jp.smoothing_length
    base = dict(cell_size=h, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    jgrid = JGrid(**base, use_pallas_slotmajor=True, pallas_sm_row_block=BR,
                  pallas_pf_unroll=False)
    js = JSolver(viscosity_model=JXSPH(h), properties=jp, grid=jgrid,
                 step_config=JFixed(1.0 / 3000.0))
    tgrid = TGrid(**base, use_pallas_slotmajor=True)
    ts = TSolver(viscosity_model=TXSPH(h), properties=tp, grid=tgrid,
                 step_config=TFixed(1.0 / 3000.0))
    jws = JWSolver(viscosity_model=JXSPH(h), properties=jp, grid=jgrid,
                   step_config=JFixed(1.0 / 3000.0))
    tws = TWSolver(viscosity_model=TXSPH(h), properties=tp, grid=tgrid,
                   step_config=TFixed(1.0 / 3000.0))
    wcsph = {
        form: jax.jit(lambda q, s, qv, sv, sc, terms=terms, n_out=n_out: pf_pair_reduce(
            terms, n_out, q, s, pass_flags(q, s, jgrid), jgrid, BR,
            q_vals=qv, s_vals=sv, scalars=sc))
        for form, (terms, n_out) in jax_wcsph_terms(jws).items()
    }
    jitted = dict(
        ctx=jax.jit(lambda q, s: pf_pair_reduce(
            jax_ctx_terms(js), 5, q, s, pass_flags(q, s, jgrid), jgrid, BR)),
        ctx_post=jax.jit(lambda p, m, b: js._ctx_pf(p, m, b, jnp.int32(0))),
        visc_gravity=jax.jit(js._viscosity_gravity_pf),
        err_ki=jax.jit(js._density_err_ki_pf),
        delta_ki=jax.jit(js._divergence_delta_ki_pf),
        corr_v=jax.jit(js._apply_correction_pf),
        **wcsph,
    )
    return h, jgrid, js, ts, tws, jitted


class Case:
    """Random fluid and boundary slot grids on a cell_size = h grid and all pass
    inputs. Live positions lie inside (or near) their own cell, so neighbours
    sit in the 3x3 window as after a re-bucket."""

    def __init__(self, seed, ny=NY, nx=NX, p=P, pb=PB, fill=0.6, bfill=0.3):
        rng = np.random.default_rng(seed)
        h, self.jgrid, self.js, self.ts, self.tws, self.jitted = solvers()
        self.ny, self.nx = ny, nx

        def slots(pp, fill_):
            mask = rng.random((ny, nx, pp)) < fill_
            cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
            cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
            pos = cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h
            return np.where(mask[..., None], pos, 0.0).astype(np.float32), mask

        self.pos, self.mask = slots(p, fill)
        self.bpos, self.bmask = slots(pb, bfill)
        f = lambda *s: rng.random((ny, nx, p) + s).astype(np.float32)
        self.v = (f(2) - 0.5) * 2.0
        self.k = (f() - 0.5) * 50.0
        self.rho = 100.0 + 30.0 * f()
        self.dens = 100.0 + 5.0 * f()
        self.alpha = 1e-3 * f()
        self.sgs = (f(2) - 0.5) * 40.0
        self.nt = np.floor(f() * 18.0)  # straddles the <9-neighbour guard
        self.pres = 500.0 * f()
        self.dt = np.float32(1.0 / 2700.0)

    # --- JAX side (TPU-padded planes)
    def j(self, a):
        return j_to_planes(jnp.asarray(a), self.jgrid, BR)

    def jgeom(self, pos, mask):
        return pf_build_geom(self.j(pos), self.j(mask).astype(bool), BR, grid=self.jgrid)

    def jctx(self):
        geom = self.jgeom(self.pos, self.mask)
        return JCtx(geom=geom, flags_dyn=pass_flags(geom, geom, self.jgrid),
                    pos=self.j(self.pos), mask=self.j(self.mask).astype(bool),
                    sum_grad_stat=self.j(self.sgs), neighbor_total=self.j(self.nt),
                    densities=self.j(self.dens), alpha=self.j(self.alpha),
                    num_dropped=jnp.int32(0))

    def jboundary(self):
        return JBoundaryPlanes(dense=None, geom=self.jgeom(self.bpos, self.bmask))

    # --- port side
    def t(self, a):
        return to_planes(torch.as_tensor(a))

    def tctx(self):
        return TCtx(pos=self.t(self.pos), mask=self.t(self.mask),
                    sum_grad_stat=self.t(self.sgs), neighbor_total=self.t(self.nt),
                    densities=self.t(self.dens), alpha=self.t(self.alpha),
                    num_dropped=torch.zeros((), dtype=torch.int32))

    def tboundary(self):
        return TBoundaryPlanes(dense=None, geom=PlaneGeom(self.t(self.bpos),
                                                          self.t(self.bmask)))

    def crop(self, a):
        return np.asarray(a)[..., :self.ny, :self.nx]


def jax_ctx_terms(solver):
    """The JAX solver's ctx pair terms (models/dfsph_plane.py _ctx_pf)."""
    m = float(solver.properties.particle_mass)

    def ctx_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
        w = solver.kernel.evaluate(r_sq, r)
        mgc = solver.kernel.gradient_coefficient(r_sq, r) * m
        gx, gy = mgc * dx, mgc * dy
        return (w, gx, gy, gx * gx + gy * gy, jnp.ones_like(r_sq))

    return ctx_terms


def jax_wcsph_terms(js):
    """The JAX WCSPH plane solver's three pair closures
    (models/wcsph_plane.py step), op for op, with their output counts."""
    m = float(js.properties.particle_mass)

    def density(dx, dy, r_sq, r, sc, q, s):
        return (js.density_kernel.evaluate(r_sq, r),)

    def stat(dx, dy, r_sq, r, sc, q, s):
        w_b = js.pressure_kernel.evaluate(r_sq, r)
        c = -js.boundary_force_factor * w_b / r_sq
        return (js.density_kernel.evaluate(r_sq, r), c * dx, c * dy)

    def forces(dx, dy, r_sq, r, scalars, q, s):
        p_i, rho_i, vx_i, vy_i = q
        p_j, rho_j, vx_j, vy_j = s
        coef = -m * (p_i + p_j) / (2.0 * rho_i * rho_j)
        gc = coef * js.pressure_kernel.gradient_coefficient(r_sq, r)
        c = js.viscosity_model.viscous_coefficient(scalars[0], r_sq, r, m, rho_j)
        return (gc * dx + c * (vx_j - vx_i), gc * dy + c * (vy_j - vy_i))

    return dict(wcsph_density=(density, 1), wcsph_stat=(stat, 3),
                wcsph_forces=(forces, 2))


def run_wcsph_form(case: Case, form: str):
    """(jax outputs, port outputs) of one WCSPH call form; stat runs against
    the boundary space, density and forces fluid -> fluid."""
    boundary = form == "wcsph_stat"
    spos, smask = (case.bpos, case.bmask) if boundary else (case.pos, case.mask)
    qv = (case.pres, case.rho, case.v) if form == "wcsph_forces" else ()
    sc = (case.dt,) if form == "wcsph_forces" else ()
    out_j = case.jitted[form](case.jgeom(case.pos, case.mask), case.jgeom(spos, smask),
                              tuple(map(case.j, qv)), tuple(map(case.j, qv)),
                              tuple(jnp.float32(x) for x in sc))
    pform = getattr(case.tws._forms, form.split("_")[1])
    out_t = tpr.pair_reduce(pform, case.tctx().geom, PlaneGeom(case.t(spos), case.t(smask)),
                            case.tws._consts, q_vals=tuple(map(case.t, qv)),
                            s_vals=tuple(map(case.t, qv)), scalars=tuple(map(float, sc)))
    return list(out_j), list(out_t)


def run_form(case: Case, form: str):
    """(jax outputs, port outputs) of one call form, as lists of planes."""
    if form.startswith("wcsph"):
        return run_wcsph_form(case, form)
    ts, jit = case.ts, case.jitted
    dt = case.dt
    if form == "ctx":
        out_j = jit["ctx"](case.jgeom(case.pos, case.mask), case.jgeom(case.bpos, case.bmask))
        out_t = tpr.pair_reduce(ts._forms.ctx, case.tctx().geom,
                                case.tboundary().geom, ts._consts)
        return list(out_j), list(out_t)
    if form == "ctx_post":
        cj = jit["ctx_post"](case.j(case.pos), case.j(case.mask).astype(bool),
                             case.jboundary())
        ct = ts._ctx_pf(case.t(case.pos), case.t(case.mask), case.tboundary(),
                        torch.zeros((), dtype=torch.int32))
        fields = ("densities", "alpha", "neighbor_total", "sum_grad_stat")
        return ([getattr(cj, f) for f in fields], [getattr(ct, f) for f in fields])
    jctx, tctx = case.jctx(), case.tctx()
    if form == "visc_gravity":
        out_j = jit[form](jctx, case.j(case.v), case.j(case.rho), dt)
        out_t = ts._viscosity_gravity_pf(tctx, case.t(case.v), case.t(case.rho), dt)
    elif form == "err_ki":
        out_j = jit[form](jctx, case.j(case.v), case.j(case.dens), case.j(case.alpha), dt)
        out_t = ts._density_err_ki_pf(
            tctx, case.t(case.v), case.t(case.dens), case.t(case.alpha), dt)
    elif form == "delta_ki":
        out_j = jit[form](jctx, case.j(case.v))
        out_t = ts._divergence_delta_ki_pf(tctx, case.t(case.v))
    else:  # corr_v
        scale = np.float32(1.0 / dt) * np.float32(case.js.properties.particle_mass)
        out_j = jit[form](jctx, case.j(case.k), case.j(case.v), scale)
        out_t = ts._apply_correction_pf(tctx, case.t(case.k), case.t(case.v), scale)
    return list(out_j), list(out_t)


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    return Case(seed=request.param)


@pytest.mark.parametrize("form", FORMS)
def test_twin_matches_jax(case, form):
    out_j, out_t = run_form(case, form)
    live = case.t(case.mask).numpy()
    assert live.any() and (~live).any()
    assert len(out_j) == len(out_t)
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        a, b = case.crop(a), b.numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        live_k = np.broadcast_to(live, a.shape)
        atol = ATOL * max(1.0, float(np.abs(a[live_k]).max()))
        np.testing.assert_allclose(b[live_k], a[live_k], rtol=RTOL, atol=atol,
                                   err_msg=f"{form} output {k}")
        assert np.isfinite(b[live_k]).all()
    # the pass did real work: some live output differs from its no-neighbour value
    assert any(np.abs(b.numpy()).sum() > 0 for b in out_t)


def test_dead_query_slots_are_zero(case):
    out = tpr.pair_reduce(case.ts._forms.ctx, case.tctx().geom, case.tctx().geom,
                          case.ts._consts)
    dead = ~case.t(case.mask)
    assert (out[:, dead] == 0).all()


def test_wrapper_dispatch_is_by_device(case):
    """CPU tensors run the twin; a tensor on any other non-CUDA device raises
    (there is no silent fallback)."""
    form = case.ts._forms.ctx
    geom = case.tctx().geom
    ref = tpr.pair_reduce_ref(form.term_fn, form.n_out, geom, geom,
                              case.ts._consts.radius_sq)
    before = dict(tpr.LAUNCHES)
    torch.testing.assert_close(
        tpr.pair_reduce(form, geom, geom, case.ts._consts), ref, rtol=0, atol=0)
    assert tpr.LAUNCHES == before  # the twin is not a launch
    meta = PlaneGeom(geom.pos.to("meta"), geom.mask.to("meta"))
    with pytest.raises(ValueError):
        tpr.pair_reduce(form, meta, meta, case.ts._consts)
