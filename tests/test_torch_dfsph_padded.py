"""The DFSPH padded step as a whole: the PyTorch port's DFSPHPaddedSolver on
both of its routes (K3 + K4 twins, `use_pallas_slotmajor=True`; K5 + K4
twins, False) against the JAX DFSPHPaddedSolver on its XLA route, jitted, on
the tiny scene of tests/test_pallas_plane.py and on the 90-particle contact
scene of tests/test_torch_dfsph_plane.py.

The JAX XLA route computes the contract of both JAX kernel routes (K5 is its
drop-in; K3 is held to it in tests/test_pallas_slotmajor.py), and its
re-bucket is bit-equal to K4; the jitted JAX slot-major solver compiles too
long in interpret mode. The pair sums come in other candidate orders (per view
or over all 9P at once, with contracted multiply-adds under XLA), so the
solvers agree to f32 drift: equal density and divergence iterations and drops
per step, dt to rtol 1e-6, sorted live positions to atol 1e-5 and densities
to rtol 1e-4 / atol 1e-2 (the tolerances of tests/test_pallas_slotmajor.py:
314-321). The ctx fields of the init agree to rtol 1e-4 plus 1e-5 of the
field's scale (gradient sums cancel)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JSolver
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TSolver
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TPlane
from yasph2d_tpu_torch.models.slot_solver import pair_route
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TWCSPH
from yasph2d_tpu_torch.ops.pallas_pair import Rebase, bf16_float, pallas_pair_reduce
from yasph2d_tpu_torch.ops.sm_pair_reduce import sm_pair_reduce
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import dfsph_padded_carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

STEPS = 6
CONVERTED_AT = 3  # the one-step test starts from the JAX carry after this step
ROUTES = {"k3": True, "k5": False}  # route -> DenseGridConfig.use_pallas_slotmajor
CONFIGS = {
    "fixed": (JFixed(1.0 / 3000.0), TFixed(1.0 / 3000.0)),
    "adaptive": (JAdaptive(1 / 360, 1 / 24000, 1.5), TAdaptive(1 / 360, 1 / 24000, 1.5)),
}
CTX_FIELDS = ("densities_pad", "alpha_pad", "neighbor_total", "sum_grad_stat")


def tiny_scene(world_cls):
    world = world_cls(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    return world


def contact_scene(world_cls):
    """90 fluid particles resting on a floor, against a wall."""
    world = world_cls(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def leaves(carry) -> dict:
    """The JAX padded carry's leaves as numpy, keyed as
    dfsph_padded_carry_from_numpy wants."""
    out = {f"ctx.{f}": np.asarray(getattr(carry.ctx, f)) for f in CTX_FIELDS + (
        "pos_pad", "mask", "num_dropped")}
    out.update({f: np.asarray(getattr(carry, f)) for f in (
        "v_pad", "kappa_pad", "stiff_pad", "prev_density_iterations",
        "prev_divergence_iterations")})
    out.update({f"time.{f}": np.asarray(getattr(carry.time, f))
                for f in carry.time._fields})
    return out


def live_rows(state):
    alive = np.asarray(state.alive)
    rows = np.concatenate(
        [np.asarray(state.positions), np.asarray(state.densities)[:, None]], axis=1
    )[alive]
    return rows[np.lexsort(rows.T)]


def counts(diag):
    return (int(diag.density_iterations), int(diag.divergence_iterations),
            int(diag.neighbor_drops))


def assert_rows_close(rows, ref, n):
    assert rows.shape == ref.shape == (n, 3)
    np.testing.assert_allclose(rows[:, :2], ref[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows[:, 2], ref[:, 2], rtol=1e-4, atol=1e-2)


class Scene:
    """One scene and step configuration: the port's solver on each route and
    the JAX reference run (init carry, the carry after every step, per-step
    diagnostics, final live rows), computed once. `velocity_noise` (m/s)
    replaces the initial velocities of live slots with seeded noise, so that
    both pressure loops iterate and warm-start."""

    def __init__(self, world_fn, jcfg, tcfg, occupancy=None, velocity_noise=0.0):
        jw, tw = world_fn(JWorld), world_fn(TWorld)
        self.n = jw.num_dynamic_particles
        h = jw.properties.smoothing_length
        kw = {} if occupancy is None else dict(occupancy=occupancy)
        jgrid, tgrid = jw.dense_grid(**kw), tw.dense_grid(**kw)
        js = JSolver(viscosity_model=JXSPH(h), properties=jw.properties, grid=jgrid,
                     step_config=jcfg)
        self.solvers = {
            route: TSolver(viscosity_model=TXSPH(h), properties=tw.properties,
                           grid=dataclasses.replace(tgrid, use_pallas_slotmajor=sm),
                           step_config=tcfg)
            for route, sm in ROUTES.items()
        }
        jdense = jw.boundary_dense(jgrid)
        # bit-equal to jdense (tests/test_torch_world.py)
        self.tb = tw.boundary_dense(tgrid, device="cpu")
        self.t_state = tw.initial_state(device="cpu")

        c = jax.jit(js.init_carry)(jw.initial_state(), jdense)
        if velocity_noise:
            rng = np.random.default_rng(42)
            noise = rng.normal(0.0, velocity_noise, c.v_pad.shape).astype(np.float32)
            c = c._replace(v_pad=jax.numpy.asarray(
                noise * np.asarray(c.ctx.mask)[..., None]))
        self.j_init = leaves(c)
        simulate = jax.jit(js.simulate, static_argnums=2)
        self.j_diags, self.j_carries = [], []
        for _ in range(STEPS):
            c, d = simulate(c, jdense, 1)
            self.j_diags.append(counts(d) + (float(d.dt),))
            self.j_carries.append(leaves(c))
        self.j_final = live_rows(js.export_state(c))


@pytest.fixture(scope="module", params=list(CONFIGS))
def tiny(request):
    jcfg, tcfg = CONFIGS[request.param]
    return Scene(tiny_scene, jcfg, tcfg, occupancy=3)


@pytest.fixture(scope="module")
def contact():
    """dt 1/250 and 3 m/s velocity noise: the loops run 1-5 iterations per
    step with warm starts."""
    return Scene(contact_scene, JFixed(1.0 / 250.0), TFixed(1.0 / 250.0),
                 velocity_noise=3.0)


def check_ctx(ctx, ref: dict):
    """The port's pair context against the JAX carry's, live slots."""
    mask = ctx.mask.numpy()
    np.testing.assert_array_equal(mask, ref["ctx.mask"])
    assert int(ctx.num_dropped) == int(ref["ctx.num_dropped"]) == 0
    for field in CTX_FIELDS:
        ours = getattr(ctx, field).numpy()
        b = ref[f"ctx.{field}"]
        live = np.broadcast_to(mask if ours.ndim == mask.ndim else mask[..., None],
                               ours.shape)
        scale = float(np.abs(b[live]).max())
        np.testing.assert_allclose(ours[live], b[live], rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=field)


@pytest.mark.parametrize("route", list(ROUTES))
def test_init_ctx_matches(tiny, route):
    """The padded init is the JAX layout bit for bit; the ctx passes of the
    route agree with the XLA passes."""
    carry = tiny.solvers[route].init_carry(tiny.t_state, tiny.tb)
    ref = tiny.j_init
    np.testing.assert_array_equal(carry.ctx.pos_pad.numpy(), ref["ctx.pos_pad"])
    assert int(carry.ctx.mask.sum()) == tiny.n
    check_ctx(carry.ctx, ref)
    for f in ("v_pad", "kappa_pad", "stiff_pad"):
        np.testing.assert_array_equal(getattr(carry, f).numpy(), ref[f], err_msg=f)
    assert (carry.prev_density_iterations, carry.prev_divergence_iterations) == (
        int(ref["prev_density_iterations"]), int(ref["prev_divergence_iterations"]))


def one_step(scene, route, k):
    """Step k + 1 of the port from the converted JAX carry after step k (the
    init carry for k = 0), against JAX's step k + 1, slot for slot: the
    re-bucket is exact, so the slots hold the same particles."""
    src = scene.j_init if k == 0 else scene.j_carries[k - 1]
    carry = dfsph_padded_carry_from_numpy(src, device="cpu")
    carry = carry._replace(time=carry.time.account_step())
    carry, diag = scene.solvers[route].step(carry, scene.tb)
    ref, jd = scene.j_carries[k], scene.j_diags[k]
    assert counts(diag) == jd[:3]
    np.testing.assert_allclose(float(diag.dt), jd[3], rtol=1e-6)
    np.testing.assert_allclose(float(carry.time.dt), float(ref["time.dt"]), rtol=1e-6)
    mask = carry.ctx.mask.numpy()
    np.testing.assert_array_equal(mask, ref["ctx.mask"])
    np.testing.assert_allclose(carry.ctx.pos_pad.numpy()[mask], ref["ctx.pos_pad"][mask],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(carry.ctx.densities_pad.numpy()[mask],
                               ref["ctx.densities_pad"][mask], rtol=1e-4, atol=1e-2)
    assert (carry.prev_density_iterations, carry.prev_divergence_iterations) == jd[:2]


@pytest.mark.parametrize("route", list(ROUTES))
def test_one_step_from_converted_carry(tiny, route):
    one_step(tiny, route, CONVERTED_AT)


def run_from_scratch(scene, route):
    solver = scene.solvers[route]
    carry = solver.init_carry(scene.t_state, scene.tb)
    out = []
    for _ in range(STEPS):
        carry, diag = solver.simulate(carry, scene.tb, 1)
        out.append(counts(diag) + (float(diag.dt),))
    return out, live_rows(solver.export_state(carry))


@pytest.mark.parametrize("route", list(ROUTES))
def test_six_steps_from_scratch(tiny, route):
    diags, rows = run_from_scratch(tiny, route)
    for k, (ours, ref) in enumerate(zip(diags, tiny.j_diags)):
        assert ours[:3] == ref[:3], k
        np.testing.assert_allclose(ours[3], ref[3], rtol=1e-6, err_msg=k)
    assert_rows_close(rows, tiny.j_final, tiny.n)
    # warm start coverage: a step after the first saw prev iterations > 1
    assert any(d[0] > 1 for d in tiny.j_diags[:-1])


@pytest.mark.parametrize("route", list(ROUTES))
def test_contact_scene_one_step_from_converted_carry(contact, route):
    """The converted carry after the first step: both loops warm-start."""
    assert contact.j_diags[0][0] > 1 or contact.j_diags[0][1] > 1
    one_step(contact, route, 1)


@pytest.mark.parametrize("route", list(ROUTES))
def test_contact_scene_steps_match(contact, route):
    """Six steps from the noisy converted init carry: per-step iteration and
    drop counts equal to JAX's, live rows to f32 drift."""
    solver = contact.solvers[route]
    carry = dfsph_padded_carry_from_numpy(contact.j_init, device="cpu")
    ours = []
    for _ in range(STEPS):
        carry, diag = solver.simulate(carry, contact.tb, 1)
        ours.append(counts(diag))
    assert ours == [d[:3] for d in contact.j_diags]
    assert max(n for n, _, _ in ours) > 1 and max(n for _, n, _ in ours) > 1
    assert_rows_close(live_rows(solver.export_state(carry)), contact.j_final, contact.n)


@pytest.fixture(scope="module")
def resting_contact():
    return Scene(contact_scene, JFixed(1.0 / 250.0), TFixed(1.0 / 250.0))


@pytest.mark.parametrize("route", list(ROUTES))
def test_contact_scene_from_scratch(resting_contact, route):
    """Six steps of the resting contact scene from the port's own init against
    JAX's: equal counts, live rows to f32 drift."""
    diags, rows = run_from_scratch(resting_contact, route)
    assert [d[:3] for d in diags] == [d[:3] for d in resting_contact.j_diags]
    assert_rows_close(rows, resting_contact.j_final, resting_contact.n)


def route_solver(cls, world_fn, slotmajor: bool, dtype: str):
    world = world_fn(TWorld)
    h = world.properties.smoothing_length
    grid = dataclasses.replace(world.dense_grid(), use_pallas_slotmajor=slotmajor,
                               pair_dtype=dtype)
    return cls(viscosity_model=TXSPH(h), properties=world.properties, grid=grid,
               step_config=TFixed(1.0 / 3000.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("method", ["dfsph", "wcsph"])
def test_routes_pick_their_kernels(method, route, dtype):
    """The grid picks the pair route once, at construction (`pair_route`):
    K3 with the slot-major closures (DFSPH: its boundary form the XLA
    closure) and live-only outputs, K5 with the XLA closures throughout and
    +0.0 at dead query slots, in K5's bf16 math mode (bf16 terms and
    constants, positions rebased) on a bfloat16 grid, which K3 refuses as
    the JAX slot-major solvers assert."""
    cls, slotmajor = (TSolver if method == "dfsph" else TWCSPH), ROUTES[route]
    if slotmajor and dtype == "bfloat16":
        with pytest.raises(ValueError, match="K3 computes on float32"):
            route_solver(cls, tiny_scene, slotmajor, dtype)
        return
    s = route_solver(cls, tiny_scene, slotmajor, dtype)
    grid = s.grid
    assert s._route == pair_route(grid)
    assert s._route.reduce is (sm_pair_reduce if slotmajor else pallas_pair_reduce)
    assert s._route.slot_major is slotmajor and s._route.dead_zero is not slotmajor
    assert s._route.rebase == (None if dtype == "float32" else Rebase(
        grid.cell_size, tuple(map(float, grid.origin)), 0))
    names = [f.name for f in s._forms]
    terms = [f.term_fn.__qualname__.rsplit(".", 1)[-1] for f in s._forms]
    order = "sm" if slotmajor else "xla"
    if method == "dfsph":
        assert names == ["dfsph_ctx", "dfsph_stat" if slotmajor else "dfsph_ctx", "dfsph_div",
                         "dfsph_corr", "dfsph_visc"]
        if dtype == "float32":  # K5 runs one form for the fluid and the boundary
            assert (s._forms.stat is s._forms.ctx) is not slotmajor
        # the loops' glue skips dead quads where the route's +0.0 makes them
        # identities, and a dead slot's density m W(0) clamps to rho0: not in
        # this coarse scene (m W(0) = 2.2 rho0), in the contact scene
        for world_fn, clamps in ((tiny_scene, False), (contact_scene, True)):
            d = route_solver(cls, world_fn, slotmajor, dtype) if clamps else s
            m = np.float32(d.properties.particle_mass)
            assert bool(m * np.float32(d._w0) <= np.float32(100.0)) is clamps
            assert bool(d._dead_zero) is (clamps and not slotmajor)
    else:
        assert names == ["wcsph_density", "wcsph_stat", "wcsph_forces"]
    if dtype == "bfloat16":
        assert all(f.bf16 for f in s._forms)
        assert s._consts.radius_sq == bf16_float(grid.radius_sq)
        assert terms == (["ctx", "ctx", "div", "corr", "dfsph_visc"] if method == "dfsph"
                         else ["density", "stat", "forces"])
    elif method == "dfsph":
        assert terms == [f"ctx_{order}", "ctx_xla", f"div_{order}", f"corr_{order}", "visc"]
    else:
        assert terms == ["density_terms", "stat_terms",
                         "force_terms" if slotmajor else "force_terms_xla"]


def test_routes_agree(tiny):
    """K3 route against K5 route over the six steps: equal counts, rows to
    f32 drift."""
    (dk3, rk3), (dk5, rk5) = (run_from_scratch(tiny, r) for r in ROUTES)
    assert [d[:3] for d in dk3] == [d[:3] for d in dk5]
    assert_rows_close(rk3, rk5, tiny.n)


def test_plane_solver_requires_slotmajor(tiny):
    """The plane solver is the slot-major path: the flag off is refused, as the
    JAX plane solver refuses it."""
    s = tiny.solvers["k5"]
    with pytest.raises(AssertionError, match="use_pallas_slotmajor"):
        TPlane(viscosity_model=s.viscosity_model, properties=s.properties, grid=s.grid,
               step_config=s.step_config)
