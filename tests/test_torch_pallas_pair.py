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
the gradient sums at h = 0.1 reach 1e4.

K5's bf16 math mode (`rebase`) is held to the XLA pair_reduce at a bfloat16
grid, every form and both physical ones, at the same tolerance: per pair
both round every operation to bf16 as the jaxpr types it, so what remains
is the f32 summation order (measured: under 1e-7 of each output's scale,
where the f32 twin is 0.4-6% of the scale away, which the test also
asserts). The JAX pass is jitted with XLA's `xla_allow_excess_precision`
off: by default XLA on the CPU keeps f32 intermediates through fused bf16
chains and skips most of the jaxpr's bf16 roundings (measured: 0.2-1.7% of
the scale from the twin, about as far as f32; the neighbour counts become
f32's)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JDFSPH
from yasph2d_tpu.models.viscosity import PhysicalViscosityModel as JPhys
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JWCSPH
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.dense_grid import build_slot_grid, cell_keys, pad_to_slots
from yasph2d_tpu.ops.dense_grid import pair_reduce as j_xla_pair_reduce
from yasph2d_tpu.ops.pallas_pair import pallas_pair_reduce as j_pallas_pair_reduce
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TDFSPH
from yasph2d_tpu_torch.models.viscosity import PhysicalViscosityModel as TPhys
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
# the viscosity models of both packages, by config kind (physical: the
# reference's high-viscosity mu, main.rs:95-96)
VISCOSITY = {"xsph": (JXSPH, TXSPH),
             "physical": (lambda h: JPhys(h, fluid_viscosity=0.01),
                          lambda h: TPhys(h, fluid_viscosity=0.01))}


@functools.lru_cache(maxsize=None)
def solvers(visc="xsph"):
    """Both packages' DFSPH and WCSPH padded solvers on the K5 route (the JAX
    ones on their XLA route: use_pallas and use_pallas_slotmajor off) with
    the `visc` model; the port's forms keyed by their XSPH names (a physical
    form's name ends in "_phys")."""
    props = dict(smoothing_factor=2.0, particle_density=400.0, fluid_density=100.0)
    jp, tp = JProps(**props), TProps(**props)
    h = jp.smoothing_length
    jvisc, tvisc = (model(h) for model in VISCOSITY[visc])
    base = dict(cell_size=h, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    jgrid, tgrid = JGrid(**base, row_block=6), TGrid(**base)
    common = dict(step_config=JFixed(1.0 / 3000.0), grid=jgrid, properties=jp,
                  viscosity_model=jvisc)
    jd, jw = JDFSPH(**common), JWCSPH(**common)
    common = dict(step_config=TFixed(1.0 / 3000.0), grid=tgrid, properties=tp,
                  viscosity_model=tvisc)
    td, tw = TDFSPH(**common), TWCSPH(**common)
    forms = {f.name.removesuffix("_phys"): f for f in (*td._forms, *tw._forms)}
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


@functools.lru_cache(maxsize=None)
def jax_bf16_pass(visc, form):
    """The XLA pair_reduce of `form`'s closure at a bfloat16 grid, jitted with
    excess precision off (module docstring)."""
    case_grid = dataclasses.replace(solvers(visc)[1], pair_dtype="bfloat16")
    closure = jax_closures(*solvers(visc)[2:4])[form]
    return jax.jit(lambda p, m, sp, sm, qv, sv, sc: j_xla_pair_reduce(
        closure, p, m, sp, sm, case_grid, source_values=sv, query_values=qv,
        scalar_args=sc), compiler_options={"xla_allow_excess_precision": False})


def stack_outputs(out) -> np.ndarray:
    """A JAX pytree of (ny, nx, P[, 2]) leaves, in order, as (ny, nx, P, n_out)."""
    leaves = jax.tree_util.tree_leaves(out)
    return np.concatenate([np.asarray(a)[..., None] if a.ndim == 3 else np.asarray(a)
                           for a in leaves], axis=-1)


class Case:
    """tests/test_pallas_pair.py's setup (random positions over the grid, cell
    sort, slot grid) for the fluid, and a 60-particle boundary space."""

    def __init__(self, seed, visc="xsph"):
        h, self.jgrid, self.jd, self.jw, self.td, self.tw, self.forms = solvers(visc)
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

    def port(self, form, boundary, bf16=False):
        """The port's twin of `form`; `bf16`: in K5's bf16 math mode, with the
        bf16 constants of the form's solver."""
        spos, smask, qv, sv, sc = self.operands(form, boundary)
        t = torch.as_tensor
        pf, consts, kw = self.forms[form], self.td._consts, {}
        if bf16:
            solver = self.tw if form.startswith("wcsph") else self.td
            consts = tpp.bf16_consts(solver._consts)
            pf = tpp.bf16_form(pf, consts)
            kw = dict(rebase=tpp.rebase_of(dataclasses.replace(solver.grid,
                                                               pair_dtype="bfloat16")))
        return tpp.pallas_pair_reduce(
            pf, t(self.pos), t(self.mask), t(spos), t(smask), consts,
            q_vals=tuple(map(t, qv)), s_vals=tuple(map(t, sv)),
            scalars=tuple(float(s) for s in sc), **kw).numpy()

    def jax_bf16(self, form, boundary, visc):
        """The JAX XLA pair_reduce of `form` at a bfloat16 grid."""
        spos, smask, qv, sv, sc = self.operands(form, boundary)
        j = jnp.asarray
        return stack_outputs(jax_bf16_pass(visc, form)(
            j(self.pos), j(self.mask), j(spos), j(smask), tuple(map(j, qv)),
            tuple(map(j, sv)), tuple(jnp.float32(s) for s in sc)))


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


def check_bf16(case, form, boundary, visc):
    """K5's bf16 twin of one form against the JAX bf16 XLA pass, at the f32
    summation-order tolerance; the f32 twin is outside it."""
    ref = case.jax_bf16(form, boundary, visc)
    out = case.port(form, boundary, bf16=True)
    assert_live_close(out, ref, case.mask, form)
    assert np.abs(out).sum() > 0
    with pytest.raises(AssertionError):
        assert_live_close(case.port(form, boundary), ref, case.mask, form)


@pytest.mark.parametrize("form,boundary", CASES, ids=IDS)
def test_bf16_twin_matches_jax_xla_pair_reduce(case, form, boundary):
    check_bf16(case, form, boundary, "xsph")


@pytest.fixture(scope="module", params=[0, 3], ids=["seed0", "seed3"])
def physical_case(request):
    return Case(seed=request.param, visc="physical")


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("form", ["dfsph_visc", "wcsph_forces"])
def test_physical_twin_matches_jax(physical_case, form, pallas):
    """The physical viscosity forms (mu = 0.01; dead sources hold rho = 0)
    against the JAX gen-1 kernel and the XLA pair_reduce with the XLA
    closures of PhysicalViscosityModel solvers."""
    assert physical_case.forms[form].name == form + "_phys"
    out = physical_case.port(form, False)
    assert_live_close(out, physical_case.jax(form, False, pallas=pallas),
                      physical_case.mask, form)
    assert np.abs(out).sum() > 0


@pytest.mark.parametrize("form", ["dfsph_visc", "wcsph_forces"])
def test_bf16_physical_twin_matches_jax(physical_case, form):
    """The physical forms in bf16: the laplacian in bf16, the rest in f32 (the
    JAX model's f32 array constant promotes), against the JAX bf16 pass."""
    check_bf16(physical_case, form, False, "physical")


def test_tile_width_fits_shared_memory():
    """The launch's tile is TILE where its block fits in shared memory, else
    TILE halved until it fits: every source space the first K5 took (a haloed
    8 x 1 column of Ps slots, a float2, the source values and a mask byte
    each, in one block) still fits; one that cannot fit even a 1 x 1 tile is
    refused with a message, not shrunk further."""
    assert tpp.tile_shape(7, 7, 4) == tpp.TILE  # the 100k fluid pass, 4 values
    assert tpp.tile_shape(7, 8, 0) == tpp.TILE  # the 100k boundary pass
    for ps, nsv in ((40, 4), (100, 0), (300, 4), (860, 0)):
        ty, tx, threads = tpp.tile_shape(7, ps, nsv)
        assert tpp.smem_bytes(ty, tx, 7, ps, nsv) <= tpp.SMEM_LIMIT
        assert ty & (ty - 1) == 0 and tx & (tx - 1) == 0 and threads == tpp.TILE[2]
        if (ty, tx) != tpp.TILE[:2]:  # shrunk: twice the tile would not fit
            assert tpp.smem_bytes(2 * ty, tx, 7, ps, nsv) > tpp.SMEM_LIMIT
    # the first K5's limit at 1 column: (8 + 2) x 3 x Ps x (8 + 4 nsv + 1) bytes
    for nsv in (0, 4):
        ps = tpp.SMEM_LIMIT // (30 * (9 + 4 * nsv))
        tpp.tile_shape(100, ps, nsv)  # any P: more slots than a round takes rounds
    assert tpp.query_round(8, 8, 7) == 8 * 8 * 8
    assert tpp.query_round(8, 8, 5000) == tpp.MAX_ROUND
    with pytest.raises(ValueError, match="shared memory"):
        tpp.tile_shape(7, 5000, 4)


def test_bf16_mode_stages_half_the_bytes():
    """The bf16 mode stages positions as bf16 pairs (4 B a slot, 8 in f32) and
    each source value as 2 B (4 in f32); the live words, the list and the warp
    counts are the same. Its launch shape starts from TILE and halves to fit
    its own bytes, so a source space that no f32 tile takes may fit in
    bf16."""
    hc = 10 * 10
    for ps, nsv in ((7, 3), (8, 0), (40, 4)):
        f32 = tpp.smem_bytes(8, 8, 7, ps, nsv)
        bf16 = tpp.smem_bytes(8, 8, 7, ps, nsv, True)
        words = -(-hc * -(-ps // 32) * 4 // 16) * 16
        rest = words + 8 * 8 * 8 * 2 + 32 * 4
        assert f32 == -(-hc * ps * 8 // 16) * 16 + -(-hc * ps * 4 * nsv // 16) * 16 + rest
        assert bf16 == -(-hc * ps * 4 // 16) * 16 + -(-hc * ps * 2 * nsv // 16) * 16 + rest
    assert tpp.tile_shape(7, 7, 4, True) == tpp.TILE
    assert tpp.tile_shape(7, 8, 0, True) == tpp.TILE
    assert tpp.tile_shape(7, 7, 4) == tpp.tile_shape(7, 7, 4, False) == tpp.TILE
    for ps, nsv in ((300, 4), (860, 0), (2000, 4)):
        ty, tx, _ = tpp.tile_shape(7, ps, nsv, True)
        assert tpp.smem_bytes(ty, tx, 7, ps, nsv, True) <= tpp.SMEM_LIMIT
        if (ty, tx) != tpp.TILE[:2]:
            assert tpp.smem_bytes(2 * ty, tx, 7, ps, nsv, True) > tpp.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tpp.tile_shape(7, 2000, 4)
    with pytest.raises(ValueError, match="shared memory"):
        tpp.tile_shape(7, 9000, 4, True)


# a source space deeper than one 32-bit live word (Ps > 32), crowded into a few
# cells, on the 20 x 10 grid, a multiple of no tile side (ragged tiles)
PS_DEEP = 40


@functools.lru_cache(maxsize=None)
def deep_sources():
    """(positions, mask) of a (NY, NX, PS_DEEP) source space with cells of
    more than 32 live slots."""
    h, jgrid = solvers()[:2]
    grid = dataclasses.replace(jgrid, occupancy=PS_DEEP)
    rng = np.random.default_rng(9)
    pos = (np.asarray([2.3, 11.6]) + rng.random((300, 2)) * [2.0, 1.5]) * h
    pos = jnp.asarray(pos.astype(np.float32))
    keys = cell_keys(pos, grid)
    order = jnp.argsort(keys)
    slots = build_slot_grid(keys[order], grid)
    mask = np.array(slots.slot_mask).reshape(NY, NX, PS_DEEP)
    return np.array(pad_to_slots(pos[order], slots, grid)), mask


@pytest.mark.parametrize("form", ["dfsph_ctx", "wcsph_stat"])
def test_twin_matches_jax_pallas_kernel_deep_sources(case, form):
    """The two fluid -> other-space passes against a source space with more
    than 32 live slots a cell (the live words K5 walks span two words)."""
    spos, smask = deep_sources()
    assert smask.sum(axis=-1).max() > 32
    j, t = jnp.asarray, torch.as_tensor
    ref = stack_outputs(j_pallas_pair_reduce(
        case.closures[form], j(case.pos), j(case.mask), j(spos), j(smask), case.jgrid,
        block_rows=BLOCK_ROWS, interpret=True))
    out = tpp.pallas_pair_reduce(case.forms[form], t(case.pos), t(case.mask), t(spos),
                                 t(smask), case.td._consts).numpy()
    assert_live_close(out, ref, case.mask, form)
    assert np.abs(out).sum() > 0


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
