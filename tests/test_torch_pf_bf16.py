"""K1's bfloat16 operand mode: the port (its plain twins on the CPU) against the
JAX package's bf16 plane path (pf_build_geom / pf_pair_reduce with
`pair_dtype="bfloat16"`, interpret mode on the CPU).

- The bf16 geometry of live slots (positions rebased onto their cell centre,
  cast to bf16) is bit-equal to JAX's `q_geom`, cropped, on a grid whose
  origin is not at zero.
- Every K1 form (six DFSPH, three WCSPH) matches JAX's bf16 pass on live
  slots to the f32 tolerance of tests/test_torch_pair_reduce.py (rtol 1e-5,
  atol 1e-6 of the plane's scale): the same bf16 operands and f32 math, but
  XLA contracts multiply-adds and CPU torch.sqrt is not correctly rounded.
- bf16 against f32 on the port keeps the envelope of tests/test_pf_bf16.py
  (W sums to 2% of their scale, gradient sums to 6%).
- The plane solvers in bf16: DFSPH gives JAX bf16's iteration and drop counts
  on every step (tiny and contact scenes of tests/test_torch_dfsph_plane.py),
  WCSPH equal drops and dt with positions to f32 drift (the scene of
  tests/test_torch_wcsph.py), tolerances as in those files.
- The padded solvers refuse bf16, and the interop converters build the bf16
  geometry from the grid."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dfsph_plane import carry_leaves, contact_scene, live_rows, scene
from test_torch_pair_reduce import jax_ctx_terms, jax_wcsph_terms
from yasph2d_tpu.models.dfsph_plane import BoundaryPlanes as JBoundaryPlanes
from yasph2d_tpu.models.dfsph_plane import DFSPHPlaneSolver as JSolver
from yasph2d_tpu.models.dfsph_plane import PlaneCtx as JCtx
from yasph2d_tpu.models.viscosity import PhysicalViscosityModel as JPhys
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_plane import WCSPHPlaneSolver as JWSolver
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.pallas_slotmajor import (
    pass_flags,
    pf_build_geom,
    pf_pair_reduce,
    to_planes as j_to_planes,
)
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TPadded
from yasph2d_tpu_torch.models.dfsph_plane import BoundaryPlanes as TBoundaryPlanes
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TSolver
from yasph2d_tpu_torch.models.dfsph_plane import PlaneCtx as TCtx
from yasph2d_tpu_torch.models.viscosity import PhysicalViscosityModel as TPhys
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TWPadded
from yasph2d_tpu_torch.models.wcsph_plane import WCSPHPlaneSolver as TWSolver
from yasph2d_tpu_torch.ops import pair_reduce as tpr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.planes import PlaneGeom, plane_geom, to_planes
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import boundary_from_numpy, carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld
from yasph2d_tpu_torch.world import FluidProperties as TProps

torch.set_num_threads(1)

BR = 4
RTOL, ATOL = 1e-5, 1e-6
FORMS = ["ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v",
         "wcsph_density", "wcsph_stat", "wcsph_forces"]
NY, NX, P, PB = 11, 17, 3, 2
ORIGIN = (-0.37, 0.21)  # not a multiple of h: the rebase must add it
# the viscosity models of both packages, by config kind (physical: the
# reference's high-viscosity mu, main.rs:95-96)
VISCOSITY = {"xsph": (JXSPH, TXSPH),
             "physical": (lambda h: JPhys(h, fluid_viscosity=0.01),
                          lambda h: TPhys(h, fluid_viscosity=0.01))}


@functools.lru_cache(maxsize=None)
def solvers(visc="xsph"):
    """The four plane solvers on one bf16 random-grid configuration with the
    `visc` model and the JAX passes, jitted once."""
    props = dict(smoothing_factor=1.0, particle_density=60.0, fluid_density=100.0)
    jp, tp = JProps(**props), TProps(**props)
    h = jp.smoothing_length
    jvisc, tvisc = (model(h) for model in VISCOSITY[visc])
    base = dict(cell_size=h, origin=ORIGIN, nx=NX, ny=NY, occupancy=P,
                use_pallas_slotmajor=True, pair_dtype="bfloat16")
    jgrid = JGrid(**base, pallas_sm_row_block=BR, pallas_pf_unroll=False)
    tgrid = TGrid(**base)
    common = dict(step_config=JFixed(1.0 / 3000.0))
    js = JSolver(viscosity_model=jvisc, properties=jp, grid=jgrid, **common)
    jws = JWSolver(viscosity_model=jvisc, properties=jp, grid=jgrid, **common)
    tcommon = dict(viscosity_model=tvisc, properties=tp, grid=tgrid,
                   step_config=TFixed(1.0 / 3000.0))
    ts, tws = TSolver(**tcommon), TWSolver(**tcommon)
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
    return h, jgrid, tgrid, js, ts, tws, jitted


class Case:
    """Random fluid and boundary slot grids with positions in (or just
    outside) their own cell, and every pass's value planes."""

    def __init__(self, seed, visc="xsph"):
        rng = np.random.default_rng(seed)
        h, self.jgrid, self.tgrid, self.js, self.ts, self.tws, self.jitted = solvers(visc)

        def slots(pp, fill):
            mask = rng.random((NY, NX, pp)) < fill
            cy, cx = np.meshgrid(np.arange(NY), np.arange(NX), indexing="ij")
            cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h + np.asarray(ORIGIN)
            pos = cell + (rng.random((NY, NX, pp, 2)) * 1.1 - 0.05) * h
            return np.where(mask[..., None], pos, 0.0).astype(np.float32), mask

        self.pos, self.mask = slots(P, 0.6)
        self.bpos, self.bmask = slots(PB, 0.3)
        f = lambda *s: rng.random((NY, NX, P) + s).astype(np.float32)  # noqa: E731
        self.v = (f(2) - 0.5) * 2.0
        self.k = (f() - 0.5) * 50.0
        self.rho = 100.0 + 30.0 * f()
        self.dens = 100.0 + 5.0 * f()
        self.alpha = 1e-3 * f()
        self.sgs = (f(2) - 0.5) * 40.0
        self.nt = np.floor(f() * 18.0)
        self.pres = 500.0 * f()
        self.dt = np.float32(1.0 / 2700.0)

    def j(self, a):
        return j_to_planes(jnp.asarray(a), self.jgrid, BR)

    def jgeom(self, pos, mask):
        return pf_build_geom(self.j(pos), self.j(mask).astype(bool), BR, grid=self.jgrid)

    def t(self, a):
        return to_planes(torch.as_tensor(a))

    def tgeom(self, pos, mask):
        return plane_geom(self.t(pos), self.t(mask), self.tgrid)

    def jctx(self):
        geom = self.jgeom(self.pos, self.mask)
        return JCtx(geom=geom, flags_dyn=pass_flags(geom, geom, self.jgrid),
                    pos=self.j(self.pos), mask=self.j(self.mask).astype(bool),
                    sum_grad_stat=self.j(self.sgs), neighbor_total=self.j(self.nt),
                    densities=self.j(self.dens), alpha=self.j(self.alpha),
                    num_dropped=jnp.int32(0))

    def tctx(self):
        return TCtx(pos=self.t(self.pos), mask=self.t(self.mask),
                    sum_grad_stat=self.t(self.sgs), neighbor_total=self.t(self.nt),
                    densities=self.t(self.dens), alpha=self.t(self.alpha),
                    num_dropped=torch.zeros((), dtype=torch.int32),
                    geom=self.tgeom(self.pos, self.mask))

    def crop(self, a):
        return np.asarray(a)[..., :NY, :NX]


@pytest.fixture(scope="module")
def case():
    return Case(seed=0)


def test_geometry_bit_equal_to_jax(case):
    """Live slots of the rebased bf16 geometry, fluid and boundary, carry
    JAX's q_geom bits; the port marks dead slots by the mask alone."""
    for pos, mask in ((case.pos, case.mask), (case.bpos, case.bmask)):
        qg = case.jgeom(pos, mask).q_geom  # (3, P, nbr, BR, NXP) bf16
        assert qg.dtype == jnp.bfloat16
        jpos = np.asarray(qg.reshape(qg.shape[:2] + (-1, qg.shape[-1]))[:2].astype(jnp.float32))
        geom = case.tgeom(pos, mask)
        assert geom.pos.dtype == torch.bfloat16 and geom.rebase_cell == case.tgrid.cell_size
        live = np.broadcast_to(geom.mask.numpy(), geom.pos.shape)
        ours = geom.pos.to(torch.float32).numpy()[live]
        ref = case.crop(jpos)[live]
        np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
        assert np.abs(ours).max() <= 0.56 * case.tgrid.cell_size  # cell-relative


def run_form(case, form):
    """(jax outputs, port outputs) of one bf16 call form, as lists of planes."""
    ts, jit, dt = case.ts, case.jitted, case.dt
    if form.startswith("wcsph"):
        boundary = form == "wcsph_stat"
        spos, smask = (case.bpos, case.bmask) if boundary else (case.pos, case.mask)
        qv = (case.pres, case.rho, case.v) if form == "wcsph_forces" else ()
        sc = (dt,) if form == "wcsph_forces" else ()
        out_j = jit[form](case.jgeom(case.pos, case.mask), case.jgeom(spos, smask),
                          tuple(map(case.j, qv)), tuple(map(case.j, qv)),
                          tuple(jnp.float32(x) for x in sc))
        out_t = tpr.pair_reduce(getattr(case.tws._forms, form.split("_")[1]),
                                case.tgeom(case.pos, case.mask), case.tgeom(spos, smask),
                                case.tws._consts, q_vals=tuple(map(case.t, qv)),
                                s_vals=tuple(map(case.t, qv)), scalars=tuple(map(float, sc)))
        return list(out_j), list(out_t)
    if form == "ctx":
        out_j = jit["ctx"](case.jgeom(case.pos, case.mask), case.jgeom(case.bpos, case.bmask))
        out_t = tpr.pair_reduce(ts._forms.ctx, case.tgeom(case.pos, case.mask),
                                case.tgeom(case.bpos, case.bmask), ts._consts)
        return list(out_j), list(out_t)
    if form == "ctx_post":
        jb = JBoundaryPlanes(dense=None, geom=case.jgeom(case.bpos, case.bmask))
        tb = TBoundaryPlanes(dense=None, geom=case.tgeom(case.bpos, case.bmask))
        cj = jit["ctx_post"](case.j(case.pos), case.j(case.mask).astype(bool), jb)
        ct = ts._ctx_pf(case.t(case.pos), case.t(case.mask), tb,
                        torch.zeros((), dtype=torch.int32))
        fields = ("densities", "alpha", "neighbor_total", "sum_grad_stat")
        return [getattr(cj, f) for f in fields], [getattr(ct, f) for f in fields]
    jctx, tctx = case.jctx(), case.tctx()
    if form == "visc_gravity":
        out_j = jit[form](jctx, case.j(case.v), case.j(case.rho), dt)
        out_t = ts._viscosity_gravity_pf(tctx, case.t(case.v), case.t(case.rho), dt)
    elif form == "err_ki":
        out_j = jit[form](jctx, case.j(case.v), case.j(case.dens), case.j(case.alpha), dt)
        out_t = ts._density_err_ki_pf(tctx, case.t(case.v), case.t(case.dens),
                                      case.t(case.alpha), dt)
    elif form == "delta_ki":
        out_j = jit[form](jctx, case.j(case.v))
        out_t = ts._divergence_delta_ki_pf(tctx, case.t(case.v))
    else:  # corr_v
        scale = np.float32(1.0 / dt) * np.float32(case.js.properties.particle_mass)
        out_j = jit[form](jctx, case.j(case.k), case.j(case.v), scale)
        out_t = ts._apply_correction_pf(tctx, case.t(case.k), case.t(case.v), scale)
    return list(out_j), list(out_t)


def check_form(case, form):
    before = dict(tpr.LAUNCHES)
    out_j, out_t = run_form(case, form)
    assert tpr.LAUNCHES == before  # CPU tensors run the twin
    live = case.t(case.mask).numpy()
    assert len(out_j) == len(out_t)
    for k, (a, b) in enumerate(zip(out_j, out_t)):
        a, b = case.crop(a), b.numpy()
        assert a.shape == b.shape, (k, a.shape, b.shape)
        live_k = np.broadcast_to(live, a.shape)
        atol = ATOL * max(1.0, float(np.abs(a[live_k]).max()))
        np.testing.assert_allclose(b[live_k], a[live_k], rtol=RTOL, atol=atol,
                                   err_msg=f"{form} output {k}")
    assert any(np.abs(b.numpy()).sum() > 0 for b in out_t)


@pytest.mark.parametrize("form", FORMS)
def test_bf16_form_matches_jax(case, form):
    check_form(case, form)


@pytest.fixture(scope="module")
def physical_case():
    return Case(seed=0, visc="physical")


@pytest.mark.parametrize("form", ["visc_gravity", "wcsph_forces"])
def test_bf16_physical_form_matches_jax(physical_case, form):
    """The physical viscosity forms (mu = 0.01) with bf16 operands against the
    JAX plane passes in bf16, as the XSPH forms."""
    assert physical_case.ts._forms.visc_gravity.name == "visc_gravity_phys"
    check_form(physical_case, form)


def test_bf16_operands_differ_from_f32(case):
    """The mode is live: bf16 operands change the sums (values rounded,
    positions rebased) while staying within the storage rounding."""
    ts = case.ts
    form = case.tws._forms.forces
    vals = (case.t(case.pres), case.t(case.rho), case.t(case.v))
    kw = dict(q_vals=vals, s_vals=vals, scalars=(float(case.dt),))
    b16 = tpr.pair_reduce(form, case.tgeom(case.pos, case.mask),
                          case.tgeom(case.pos, case.mask), ts._consts, **kw)
    f32 = PlaneGeom(case.t(case.pos), case.t(case.mask))
    ref = tpr.pair_reduce(form, f32, f32, ts._consts, **kw)
    assert not torch.equal(b16, ref)
    torch.testing.assert_close(b16, ref, rtol=0.05, atol=0.05 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="operand mode"):
        tpr.pair_reduce(form, f32, case.tgeom(case.pos, case.mask), ts._consts, **kw)


def small_dam_break(world_cls, particle_density=1600.0):
    """tests/test_wcsph.py small_dam_break on `world_cls`."""
    world = world_cls(2.0, particle_density, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    for args in [((0.0, 2.5), (2.0, 2.5), 4), ((0.0, 0.0), (2.0, 0.0), 4),
                 ((0.0, 0.0), (0.0, 2.5), 4), ((2.0, 0.0), (2.0, 2.5), 4),
                 ((0.0, 0.6), (1.75, 0.5), 2), ((0.0, 2.5), (2.0, 2.5), 2),
                 ((-2.0, -0.5), (4.0, -0.5), 4)]:
        world.add_boundary_thick_line(*args)
    return world


def test_bf16_envelope_against_f32():
    """tests/test_pf_bf16.py:57-90 on the port: the ctx sums with bf16
    operands against f32 on the small dam-break at occupancy 12."""
    world = small_dam_break(TWorld)
    grid32 = dataclasses.replace(world.dense_grid(occupancy=12), use_pallas_slotmajor=True)
    grid16 = dataclasses.replace(grid32, pair_dtype="bfloat16")
    solver = TSolver(viscosity_model=TXSPH(world.properties.smoothing_length),
                     properties=world.properties, grid=grid32,
                     step_config=TFixed(1.0 / 3000.0))
    base = solver._padded_init(world.initial_state(device="cpu"),
                               world.boundary_dense(grid32, device="cpu"))
    pos, mask = to_planes(base.pos_pad), to_planes(base.mask)
    outs = {}
    for name, grid in (("f32", grid32), ("bf16", grid16)):
        geom = plane_geom(pos, mask, grid)
        outs[name] = tpr.pair_reduce(solver._forms.ctx, geom, geom, solver._consts)
    live = mask.expand(5, *mask.shape)
    f32, b16 = outs["f32"][live].reshape(5, -1), outs["bf16"][live].reshape(5, -1)
    w_scale = float(f32[0].abs().max())
    torch.testing.assert_close(b16[0], f32[0], rtol=0, atol=0.02 * w_scale)
    for k in (1, 2):
        torch.testing.assert_close(b16[k], f32[k], rtol=0,
                                   atol=0.06 * float(f32[k].abs().max()))
    assert not torch.equal(b16, f32)


@pytest.mark.parametrize("solver_cls", [TPadded, TWPadded])
@pytest.mark.parametrize("slotmajor", [True, False])
def test_padded_solvers_refuse_bf16(solver_cls, slotmajor):
    world = TWorld(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    grid = dataclasses.replace(world.dense_grid(occupancy=3), pair_dtype="bfloat16",
                               use_pallas_slotmajor=slotmajor)
    h = world.properties.smoothing_length
    match = "K3" if slotmajor else r"the padded solvers' bf16 math mode, ROADMAP.md Queue 1\)"
    with pytest.raises(ValueError, match=match):
        solver_cls(viscosity_model=TXSPH(h), properties=world.properties, grid=grid,
                   step_config=TFixed(1.0 / 3000.0))
    with pytest.raises(ValueError, match="pair_dtype"):
        dataclasses.replace(grid, pair_dtype="float16")


def dfsph_pair(world_j, world_t, step_cfgs, **grid_kw):
    """The JAX and port plane DFSPH solvers on bf16 grids of one scene."""
    h = world_j.properties.smoothing_length
    jgrid = dataclasses.replace(world_j.dense_grid(**grid_kw), use_pallas_slotmajor=True,
                                pallas_sm_row_block=4, pair_dtype="bfloat16")
    tgrid = dataclasses.replace(world_t.dense_grid(**grid_kw), use_pallas_slotmajor=True,
                                pair_dtype="bfloat16")
    js = JSolver(viscosity_model=JXSPH(h), properties=world_j.properties, grid=jgrid,
                 step_config=step_cfgs[0])
    ts = TSolver(viscosity_model=TXSPH(h), properties=world_t.properties, grid=tgrid,
                 step_config=step_cfgs[1])
    return js, ts


def test_dfsph_plane_bf16_counts_match_jax():
    """Six adaptive steps from scratch on the tiny scene: per-step iteration
    and drop counts equal JAX bf16's; live rows to f32 drift."""
    jw, tw = scene(JWorld), scene(TWorld)
    js, ts = dfsph_pair(jw, tw, (JAdaptive(1 / 360, 1 / 24000, 1.5),
                                 TAdaptive(1 / 360, 1 / 24000, 1.5)), occupancy=3)
    jb = js.boundary_planes(jw.boundary_dense(js.grid))
    tb = ts.boundary_planes(tw.boundary_dense(ts.grid, device="cpu"))
    assert tb.geom.pos.dtype == torch.bfloat16
    c = jax.jit(js.init_carry)(jw.initial_state(), jb)
    simulate = jax.jit(js.simulate, static_argnums=2)
    carry = ts.init_carry(tw.initial_state(device="cpu"), tb)
    assert carry.ctx.geom.pos.dtype == torch.bfloat16
    for k in range(6):
        c, dj = simulate(c, jb, 1)
        carry, dt_ = ts.simulate(carry, tb, 1)
        assert (dt_.density_iterations, dt_.divergence_iterations, dt_.neighbor_drops) == (
            int(dj.density_iterations), int(dj.divergence_iterations),
            int(dj.neighbor_drops)), k
    rows_j, rows_t = live_rows(js.export_state(c)), live_rows(ts.export_state(carry))
    assert rows_t.shape == rows_j.shape == (jw.num_dynamic_particles, 3)
    np.testing.assert_allclose(rows_t[:, :2], rows_j[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows_t[:, 2], rows_j[:, 2], rtol=1e-5, atol=1e-3)


def test_dfsph_plane_bf16_contact_counts_match_jax():
    """The contact scene with seeded 3 m/s velocities (both loops iterate and
    warm-start), from the same converted carry: equal counts per step."""
    jw, tw = contact_scene(JWorld), contact_scene(TWorld)
    js, ts = dfsph_pair(jw, tw, (JFixed(1.0 / 250.0), TFixed(1.0 / 250.0)))
    jdense = jw.boundary_dense(js.grid)
    jb = js.boundary_planes(jdense)
    c = jax.jit(js.init_carry)(jw.initial_state(), jb)
    noise = np.random.default_rng(42).normal(0.0, 3.0, c.v.shape).astype(np.float32)
    c = c._replace(v=jnp.asarray(noise * np.asarray(c.ctx.mask)))
    # the converters build the bf16 geometry from the grid
    carry = carry_from_numpy(carry_leaves(c), ts.grid, device="cpu")
    boundary = boundary_from_numpy({f: np.asarray(getattr(jdense, f)) for f in jdense._fields},
                                   ts.grid, device="cpu")
    assert carry.ctx.geom.pos.dtype == boundary.geom.pos.dtype == torch.bfloat16
    assert torch.equal(boundary.geom.pos, ts.boundary_planes(boundary.dense).geom.pos)
    simulate = jax.jit(js.simulate, static_argnums=2)
    counts_j, counts_t = [], []
    for _ in range(4):
        c, d = simulate(c, jb, 1)
        counts_j.append((int(d.density_iterations), int(d.divergence_iterations),
                         int(d.neighbor_drops)))
        carry, d = ts.simulate(carry, boundary, 1)
        counts_t.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    assert counts_t == counts_j
    assert max(n for n, _, _ in counts_j) > 1 and max(n for _, n, _ in counts_j) > 1
    rows_j, rows_t = live_rows(js.export_state(c)), live_rows(ts.export_state(carry))
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=1e-5)


def test_wcsph_plane_bf16_matches_jax():
    """Six adaptive steps (CFL 0.2) of the WCSPH plane solvers in bf16 on the
    scene of tests/test_torch_wcsph.py: equal drops and dt per step, sorted
    live rows to f32 drift."""
    jw, tw = scene(JWorld), scene(TWorld)
    h = jw.properties.smoothing_length
    jgrid = dataclasses.replace(jw.dense_grid(occupancy=3), use_pallas_slotmajor=True,
                                pallas_sm_row_block=4, pair_dtype="bfloat16")
    tgrid = dataclasses.replace(tw.dense_grid(occupancy=3), use_pallas_slotmajor=True,
                                pair_dtype="bfloat16")
    js = JWSolver(viscosity_model=JXSPH(h), properties=jw.properties, grid=jgrid,
                  step_config=JAdaptive(1 / 360, 1 / 24000, 0.2))
    ts = TWSolver(viscosity_model=TXSPH(h), properties=tw.properties, grid=tgrid,
                  step_config=TAdaptive(1 / 360, 1 / 24000, 0.2))
    jb = js.boundary_planes(jw.boundary_dense(jgrid))
    tb = ts.boundary_planes(tw.boundary_dense(tgrid, device="cpu"))
    c = jax.jit(js.init_carry)(jw.initial_state())
    simulate = jax.jit(js.simulate, static_argnums=2)
    carry = ts.init_carry(tw.initial_state(device="cpu"))
    for k in range(6):
        c, dj = simulate(c, jb, 1)
        carry, dt_ = ts.simulate(carry, tb, 1)
        assert dt_.neighbor_drops == int(dj.neighbor_drops) == 0, k
        np.testing.assert_allclose(float(dt_.dt), float(dj.dt), rtol=1e-6, err_msg=k)
    rows_j, rows_t = live_rows(js.export_state(c)), live_rows(ts.export_state(carry))
    assert rows_t.shape == rows_j.shape == (jw.num_dynamic_particles, 3)
    np.testing.assert_allclose(rows_t[:, :2], rows_j[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows_t[:, 2], rows_j[:, 2], rtol=1e-5, atol=1e-3)
    assert np.abs(rows_t[:, 2] - 100.0).max() > 1.0  # the pressure did real work
