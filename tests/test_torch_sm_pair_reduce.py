"""K3 (slot-major pair reduction): the port's plain twin in its eight call forms
(three WCSPH, five DFSPH) against the JAX sm_pair_reduce, which runs in
interpret mode on the CPU (as tests/test_pallas_slotmajor.py runs it), on
random slot grids and on distinct query (fluid) / source (boundary) spaces
with Ps != P; and the boundary forms against the JAX XLA
dense_grid.pair_reduce, which is what the JAX padded steps run for that pass.

Tolerance on live slots: rtol 1e-5, and atol 1e-6 in units of the output's
largest magnitude. The (dyv, dxv, sp) accumulation order is the kernel's on
both sides, but XLA contracts multiply-adds where PyTorch rounds each op, and
the XLA pair_reduce sums its candidates in another order; where terms of both
signs cancel (the force sums), an ulp is large against the result but not
against the output's scale."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JDFSPH
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JSolver
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.dense_grid import pair_reduce as j_xla_pair_reduce
from yasph2d_tpu.ops.pallas_slotmajor import build_geom, pass_flags, sm_pair_reduce
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TDFSPH
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TSolver
from yasph2d_tpu_torch.ops import sm_pair_reduce as tsm
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.world import FluidProperties as TProps

torch.set_num_threads(1)

BR = 4
RTOL, ATOL = 1e-5, 1e-6
NY, NX, P, PB = 9, 7, 3, 2
DT = np.float32(1.0 / 2700.0)


@functools.lru_cache(maxsize=None)
def solvers():
    """The WCSPH and DFSPH padded solvers of both packages on one grid, and the
    JAX passes jitted once per form (the interpret-mode compiles dominate the
    test time)."""
    props = dict(smoothing_factor=2.0, particle_density=400.0, fluid_density=100.0)
    jp, tp = JProps(**props), TProps(**props)
    h = jp.smoothing_length
    base = dict(cell_size=h, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    jgrid = JGrid(**base, use_pallas_slotmajor=True, pallas_sm_row_block=BR)
    js = JSolver(viscosity_model=JXSPH(h), properties=jp, grid=jgrid,
                 step_config=JFixed(1.0 / 3000.0))
    tgrid = TGrid(**base, use_pallas_slotmajor=True)
    ts = TSolver(viscosity_model=TXSPH(h), properties=tp, grid=tgrid,
                 step_config=TFixed(1.0 / 3000.0))
    jd = JDFSPH(viscosity_model=JXSPH(h), properties=jp, grid=jgrid,
                step_config=JFixed(1.0 / 3000.0))
    td = TDFSPH(viscosity_model=TXSPH(h), properties=tp, grid=tgrid,
                step_config=TFixed(1.0 / 3000.0))
    terms, n_out = jax_terms(js)
    dterms, dn_out = jax_dfsph_terms(jd)
    terms.update(dterms)
    n_out.update(dn_out)
    forms = {f.name: f for f in ts._forms}
    forms.update({f.name: f for f in td._padded_forms})

    def run(form, qp, qm, sp, sm, q_vals=(), s_vals=(), scalars=()):
        q, s = build_geom(qp, qm, BR), build_geom(sp, sm, BR)
        return jnp.stack(sm_pair_reduce(
            terms[form], n_out[form], q, s, pass_flags(q, s), jgrid, BR,
            q_vals=q_vals, s_vals=s_vals, scalars=scalars, interpret=True), axis=-1)

    jitted = {form: jax.jit(functools.partial(run, form)) for form in terms}
    return h, jgrid, js, jd, ts, forms, jitted


def jax_terms(js):
    """The JAX padded solver's slot-major closures (models/wcsph_dense.py
    _density_and_forces), op for op."""
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

    terms = dict(wcsph_density=density, wcsph_stat=stat, wcsph_forces=forces)
    return terms, dict(wcsph_density=1, wcsph_stat=3, wcsph_forces=2)


def jax_dfsph_terms(jd):
    """The JAX DFSPH padded solver's slot-major closures
    (models/dfsph_dense.py:284-289, 381-386, 431-435, 468-475), op for op, and
    for the boundary pass its XLA closure (:269-276) in plane form."""
    m = float(jd.properties.particle_mass)
    k = jd.kernel

    def ctx(dx, dy, r_sq, r, sc, q, s):
        w = k.evaluate(r_sq, r)
        mgc = k.gradient_coefficient(r_sq, r) * m
        gx, gy = mgc * dx, mgc * dy
        return (w, gx, gy, gx * gx + gy * gy, jnp.ones_like(r_sq))

    def stat(dx, dy, r_sq, r, sc, q, s):
        gc = k.gradient_coefficient(r_sq, r)
        gx, gy = (gc * dx) * m, (gc * dy) * m
        return (k.evaluate(r_sq, r), gx, gy, gx * gx + gy * gy, jnp.ones_like(r_sq))

    def div(dx, dy, r_sq, r, sc, q, s):
        gc = k.gradient_coefficient(r_sq, r)
        return (((q[0] - s[0]) * dx + (q[1] - s[1]) * dy) * gc,)

    def corr(dx, dy, r_sq, r, sc, q, s):
        kk = (q[0] + s[0]) * k.gradient_coefficient(r_sq, r)
        return (kk * dx, kk * dy)

    def visc(dx, dy, r_sq, r, scalars, q, s):
        c = jd.viscosity_model.viscous_coefficient(scalars[0], r_sq, r, m, s[2])
        return (c * (s[0] - q[0]), c * (s[1] - q[1]))

    terms = dict(dfsph_ctx=ctx, dfsph_stat=stat, dfsph_div=div, dfsph_corr=corr,
                 dfsph_visc=visc)
    return terms, dict(dfsph_ctx=5, dfsph_stat=5, dfsph_div=1, dfsph_corr=2,
                       dfsph_visc=2)


class Case:
    """Random fluid (P slots) and boundary (PB slots) slot grids on a
    cell_size = h grid, live positions in or near their own cell, and seeded
    pressure, density and velocity values."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        h, self.jgrid, self.js, self.jd, self.ts, self.forms, self.jitted = solvers()

        def slots(pp, fill):
            mask = rng.random((NY, NX, pp)) < fill
            cy, cx = np.meshgrid(np.arange(NY), np.arange(NX), indexing="ij")
            cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
            pos = cell + (rng.random((NY, NX, pp, 2)) * 1.1 - 0.05) * h
            return np.where(mask[..., None], pos, 0.0).astype(np.float32), mask

        self.pos, self.mask = slots(P, 0.6)
        self.bpos, self.bmask = slots(PB, 0.4)
        f = lambda *s: rng.random((NY, NX, P) + s).astype(np.float32)
        self.pres = 500.0 * f()
        self.rho = 100.0 + 30.0 * f()
        self.v = (f(2) - 0.5) * 2.0
        self.k = 50.0 * (f() - 0.5)
        # dead slots hold rho = 0: the XSPH term divides by it (NaN hygiene)
        self.rho_live = np.where(self.mask, self.rho, 0.0).astype(np.float32)

    def operands(self, form, boundary):
        """(source pos, source mask, q_vals, s_vals, scalars) as numpy."""
        spos, smask = (self.bpos, self.bmask) if boundary else (self.pos, self.mask)
        vals = (self.pres, self.rho, self.v)
        q_vals, s_vals, scalars = {
            "wcsph_forces": (vals, vals, (DT,)),
            "dfsph_div": ((self.v,), (self.v,), ()),
            "dfsph_corr": ((self.k,), (self.k,), ()),
            "dfsph_visc": ((self.v,), (self.v, self.rho_live), (DT,)),
        }.get(form, ((), (), ()))
        return spos, smask, q_vals, s_vals, scalars

    def run(self, form, boundary=False):
        spos, smask, qv, sv, sc = self.operands(form, boundary)
        j = lambda a: jnp.asarray(a)
        out_j = self.jitted[form](j(self.pos), j(self.mask), j(spos), j(smask),
                                  tuple(map(j, qv)), tuple(map(j, sv)),
                                  tuple(jnp.float32(s) for s in sc))
        t = torch.as_tensor
        out_t = tsm.sm_pair_reduce(
            self.forms[form], t(self.pos), t(self.mask),
            t(spos), t(smask), self.ts._consts, q_vals=tuple(map(t, qv)),
            s_vals=tuple(map(t, sv)), scalars=tuple(float(s) for s in sc))
        return np.asarray(out_j), out_t.numpy()


def assert_live_close(out_t, ref, mask, what):
    live = np.broadcast_to(mask[..., None], ref.shape)
    assert out_t.shape == ref.shape, (out_t.shape, ref.shape)
    for k in range(ref.shape[-1]):
        a, b = out_t[..., k][mask], ref[..., k][mask]
        atol = ATOL * max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=f"{what} {k}")
    assert np.isfinite(out_t[live]).all()
    assert (out_t[~live] == 0).all()  # dead query slots


@pytest.fixture(scope="module", params=[0, 1], ids=["seed0", "seed1"])
def case(request):
    return Case(seed=request.param)


@pytest.mark.parametrize("form,boundary", [
    ("wcsph_density", False),
    ("wcsph_stat", True),  # Ps = 2 boundary slots against P = 3 queries
    ("wcsph_stat", False),
    ("wcsph_forces", False),  # vector values in query and source positions
    ("dfsph_ctx", False),
    ("dfsph_stat", True),  # the boundary pass, in the XLA closure's order
    ("dfsph_div", False),
    ("dfsph_corr", False),  # scalar values
    ("dfsph_visc", False),  # dead sources hold rho = 0
], ids=["density", "stat[boundary]", "stat[fluid]", "forces", "dfsph_ctx",
        "dfsph_stat[boundary]", "dfsph_div", "dfsph_corr", "dfsph_visc"])
def test_twin_matches_jax_kernel(case, form, boundary):
    out_j, out_t = case.run(form, boundary)
    assert case.mask.any() and (~case.mask).any()
    assert_live_close(out_t, out_j, case.mask, form)
    assert np.abs(out_t).sum() > 0  # the pass did real work


def test_stat_twin_matches_jax_xla_pair_reduce(case):
    """The boundary pass the JAX padded step really runs: the XLA
    dense_grid.pair_reduce with the same terms (models/wcsph_dense.py:144-158)."""
    js = case.js

    def stat_terms(ri_to_rj, r_sq, r):
        w_b = js.pressure_kernel.evaluate(r_sq, r)
        c = -js.boundary_force_factor * w_b / r_sq
        return {"w": js.density_kernel.evaluate(r_sq, r),
                "force": c[..., None] * ri_to_rj}

    j = jnp.asarray
    ref = j_xla_pair_reduce(stat_terms, j(case.pos), j(case.mask), j(case.bpos),
                            j(case.bmask), case.jgrid)
    ref = np.concatenate([np.asarray(ref["w"])[..., None], np.asarray(ref["force"])], -1)
    _, out_t = case.run("wcsph_stat", boundary=True)
    assert_live_close(out_t, ref, case.mask, "stat vs XLA")


def test_dfsph_stat_twin_matches_jax_xla_pair_reduce(case):
    """The DFSPH boundary ctx pass the JAX padded step runs: the XLA
    dense_grid.pair_reduce with its `terms` closure (models/dfsph_dense.py:269-305)."""
    jd, m = case.jd, float(case.jd.properties.particle_mass)

    def terms(ri_to_rj, r_sq, r):
        mgrad = jd.kernel.gradient(ri_to_rj, r_sq, r) * m
        return {"w": jd.kernel.evaluate(r_sq, r), "vec": mgrad,
                "sq": jnp.sum(mgrad * mgrad, axis=-1), "count": jnp.ones_like(r_sq)}

    j = jnp.asarray
    ref = j_xla_pair_reduce(terms, j(case.pos), j(case.mask), j(case.bpos),
                            j(case.bmask), case.jgrid)
    ref = np.concatenate([np.asarray(ref["w"])[..., None], np.asarray(ref["vec"]),
                          np.asarray(ref["sq"])[..., None],
                          np.asarray(ref["count"])[..., None]], -1)
    _, out_t = case.run("dfsph_stat", boundary=True)
    assert_live_close(out_t, ref, case.mask, "dfsph stat vs XLA")


def test_wrapper_dispatch_is_by_device(case):
    """CPU tensors run the twin (no launch counted); a tensor on any other
    non-CUDA device raises, and a form with an epilogue is refused."""
    form = case.forms["wcsph_density"]
    t = torch.as_tensor
    pos, mask = t(case.pos), t(case.mask)
    before = dict(tsm.LAUNCHES)
    ref = tsm.sm_pair_reduce_ref(form.term_fn, 1, pos, mask, pos, mask,
                                 case.ts._consts.radius_sq)
    torch.testing.assert_close(
        tsm.sm_pair_reduce(form, pos, mask, pos, mask, case.ts._consts), ref,
        rtol=0, atol=0)
    assert tsm.LAUNCHES == before
    with pytest.raises(ValueError):
        tsm.sm_pair_reduce(form, pos.to("meta"), mask.to("meta"), pos.to("meta"),
                           mask.to("meta"), case.ts._consts)
    with pytest.raises(ValueError):
        tsm.sm_pair_reduce(dataclasses.replace(form, post_fn=lambda *a: a),
                           pos, mask, pos, mask, case.ts._consts)
