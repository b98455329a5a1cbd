"""WCSPH as a whole: the port's Tait equation of state, and its solvers
(padded slot-major on K3 + K4 twins and on K5 + K4 twins; plane: K1 + K2
twins) against the JAX WCSPHPaddedSolver on its XLA path, on the scene of
tests/test_wcsph_plane.py:148-152.

The JAX reference runs the XLA pair_reduce and rebucket, to which the JAX
slot-major kernels are held (tests/test_pallas_slotmajor.py); the jitted JAX
slot-major solver compiles too long in interpret mode for these tests. Its
re-bucket is bit-exact to K4's, its pair sums agree with K3's to f32 rounding
(another candidate order, contracted multiply-adds), so the solvers agree to
f32 drift: equal drops, dt to rtol 1e-6, sorted live rows with positions to
atol 1e-5 and densities to rtol 1e-5 / atol 1e-3 (the tolerances of
tests/test_wcsph_plane.py:177-178)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph import compute_stiffness as j_stiffness
from yasph2d_tpu.models.wcsph import tait_pressure as j_tait
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JPadded
from yasph2d_tpu.models.wcsph_plane import WCSPHPlaneSolver as JPlane
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu.world import FluidProperties as JProps
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph import compute_stiffness
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TPadded
from yasph2d_tpu_torch.models.wcsph_plane import WCSPHPlaneCarry
from yasph2d_tpu_torch.models.wcsph_plane import WCSPHPlaneSolver as TPlane
from yasph2d_tpu_torch.ops.planes import to_planes
from yasph2d_tpu_torch.ops.slot_glue import tait_pressure
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import (
    boundary_from_numpy,
    wcsph_padded_carry_from_numpy,
    wcsph_plane_carry_from_numpy,
)
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld
from yasph2d_tpu_torch.world import FluidProperties as TProps

torch.set_num_threads(1)

STEPS = 6
CONVERTED_AT = 3  # the one-step test starts from the JAX carry after this step
CONFIGS = {
    "fixed": (JFixed(1.0 / 3000.0), TFixed(1.0 / 3000.0)),
    # the WCSPH CFL of bench.py:116-120
    "adaptive": (JAdaptive(1 / 360, 1 / 24000, 0.2), TAdaptive(1 / 360, 1 / 24000, 0.2)),
}


@pytest.mark.parametrize("variation,speed", [(0.01, 1.0), (0.003, 2.5)])
def test_stiffness_and_tait_bit_equal(variation, speed):
    """compute_stiffness is the same double; tait_pressure the same f32 bits as
    JAX's operations run one by one. (Under jit, XLA on the CPU rewrites the
    division by rho0 into a reciprocal multiply and contracts the final
    subtract into an FMA, so jitted JAX is 1 ulp away on a third of inputs.)"""
    props = dict(smoothing_factor=2.0, particle_density=1600.0, fluid_density=100.0)
    sj = j_stiffness(JProps(**props), variation, speed)
    st = compute_stiffness(TProps(**props), variation, speed)
    assert st == sj
    rng = np.random.default_rng(0)
    dens = np.concatenate([rng.uniform(90.0, 260.0, 4096),
                           [100.0, 99.99, 100.01, 0.0, np.inf]]).astype(np.float32)
    ref = np.asarray(j_tait(sj, 100.0, jnp.asarray(dens)))
    ours = tait_pressure(st, 100.0, torch.as_tensor(dens)).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))


def scene(world_cls):
    world = world_cls(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    return world


def live_rows(state):
    alive = np.asarray(state.alive)
    rows = np.concatenate(
        [np.asarray(state.positions), np.asarray(state.densities)[:, None]], axis=1
    )[alive]
    return rows[np.lexsort(rows.T)]


def leaves(carry) -> dict:
    out = {f: np.asarray(getattr(carry, f)) for f in carry._fields if f != "time"}
    out.update({f"time.{f}": np.asarray(getattr(carry.time, f))
                for f in carry.time._fields})
    return out


class Run:
    """One step configuration: the port's two solvers and the JAX reference run
    (init carry, carries after steps CONVERTED_AT and CONVERTED_AT + 1,
    per-step diagnostics, final live rows), computed once."""

    def __init__(self, config_name):
        jcfg, tcfg = CONFIGS[config_name]
        jw, tw = scene(JWorld), scene(TWorld)
        self.n = jw.num_dynamic_particles
        h = jw.properties.smoothing_length
        self.tgrid = dataclasses.replace(tw.dense_grid(occupancy=3),
                                         use_pallas_slotmajor=True)
        self.jgrid = jw.dense_grid(occupancy=3)
        self.js = JPadded(viscosity_model=JXSPH(h), properties=jw.properties,
                          grid=self.jgrid, step_config=jcfg)
        common = dict(viscosity_model=TXSPH(h), properties=tw.properties,
                      grid=self.tgrid, step_config=tcfg)
        self.padded, self.plane = TPadded(**common), TPlane(**common)
        # the K5 route: use_pallas_slotmajor off, as the JAX XLA route
        self.padded_k5 = TPadded(**dict(common, grid=dataclasses.replace(
            self.tgrid, use_pallas_slotmajor=False)))
        jdense = jw.boundary_dense(self.jgrid)
        self.jb = jdense
        self.tb = tw.boundary_dense(self.tgrid, device="cpu")
        self.tb_planes = self.plane.boundary_planes(self.tb)
        self.tb_leaves = {f: np.asarray(getattr(jdense, f)) for f in jdense._fields}
        self.t_state = tw.initial_state(device="cpu")

        c = jax.jit(self.js.init_carry)(jw.initial_state())
        self.j_init = leaves(c)
        jplane = JPlane(viscosity_model=JXSPH(h), properties=jw.properties,
                        grid=dataclasses.replace(self.jgrid, use_pallas_slotmajor=True,
                                                 pallas_sm_row_block=4),
                        step_config=jcfg)
        self.j_plane_init = leaves(jax.jit(jplane.init_carry)(jw.initial_state()))
        simulate = jax.jit(self.js.simulate, static_argnums=2)
        self.j_diags, self.j_carries = [], []
        for _ in range(STEPS):
            c, d = simulate(c, self.jb, 1)
            self.j_diags.append(d)
            self.j_carries.append(leaves(c))
        self.j_final = live_rows(self.js.export_state(c))


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    return Run(request.param)


def test_init_matches(run):
    """Both inits equal the JAX padded init bit for bit (the plane one through
    the JAX plane init's cropped planes)."""
    carry = run.padded.init_carry(run.t_state)
    ref = wcsph_padded_carry_from_numpy(run.j_init, device="cpu")
    for f in ("pos_pad", "v_pad", "accel_pad", "dens_pad", "mask"):
        torch.testing.assert_close(getattr(carry, f), getattr(ref, f), rtol=0, atol=0,
                                   msg=f)
    assert int(carry.mask.sum()) == run.n
    plane = run.plane.init_carry(run.t_state)
    ref = wcsph_plane_carry_from_numpy(run.j_plane_init, run.tgrid, device="cpu")
    for f in ("pos", "v", "accel", "dens", "mask"):
        torch.testing.assert_close(getattr(plane, f), getattr(ref, f), rtol=0, atol=0,
                                   msg=f)
    assert float(plane.time.dt) == float(carry.time.dt) == float(ref.time.dt)


def check_step(run, carry, diag, layout):
    """One port step from the converted JAX carry after CONVERTED_AT steps,
    slot for slot against the JAX step (the re-bucket is exact, so the slots
    hold the same particles)."""
    ref, jd = run.j_carries[CONVERTED_AT], run.j_diags[CONVERTED_AT]
    assert diag.neighbor_drops == int(jd.neighbor_drops) == 0
    np.testing.assert_allclose(float(diag.dt), float(jd.dt), rtol=1e-6)
    np.testing.assert_allclose(float(carry.time.dt), float(ref["time.dt"]), rtol=1e-6)
    if layout == "plane":
        fields = {"pos": "pos_pad", "v": "v_pad", "dens": "dens_pad"}
        conv = lambda a: to_planes(torch.as_tensor(np.array(a))).numpy()  # noqa: E731
        vector_live = lambda m: m[None]  # noqa: E731
    else:
        fields = {"pos_pad": "pos_pad", "v_pad": "v_pad", "dens_pad": "dens_pad"}
        conv = np.asarray
        vector_live = lambda m: m[..., None]  # noqa: E731
    mask = carry.mask.numpy()
    np.testing.assert_array_equal(mask, conv(ref["mask"]))
    for ours, key in fields.items():
        a, b = getattr(carry, ours).numpy(), conv(ref[key])
        live = np.broadcast_to(mask if a.ndim == mask.ndim else vector_live(mask), a.shape)
        np.testing.assert_allclose(a[live], b[live], rtol=1e-5, atol=1e-6, err_msg=key)


def test_padded_one_step_from_converted_carry(run):
    carry = wcsph_padded_carry_from_numpy(run.j_carries[CONVERTED_AT - 1], device="cpu")
    boundary = boundary_from_numpy(run.tb_leaves, device="cpu").dense
    carry = carry._replace(time=carry.time.account_step())
    carry, diag = run.padded.step(carry, boundary)
    check_step(run, carry, diag, "padded")


def test_padded_k5_one_step_from_converted_carry(run):
    carry = wcsph_padded_carry_from_numpy(run.j_carries[CONVERTED_AT - 1], device="cpu")
    boundary = boundary_from_numpy(run.tb_leaves, device="cpu").dense
    carry = carry._replace(time=carry.time.account_step())
    carry, diag = run.padded_k5.step(carry, boundary)
    check_step(run, carry, diag, "padded")


def test_plane_one_step_from_converted_carry(run):
    c = wcsph_padded_carry_from_numpy(run.j_carries[CONVERTED_AT - 1], device="cpu")
    carry = WCSPHPlaneCarry(*(to_planes(a) for a in c[:-1]), time=c.time.account_step())
    carry, diag = run.plane.step(carry, boundary_from_numpy(run.tb_leaves, device="cpu"))
    check_step(run, carry, diag, "plane")


@pytest.mark.parametrize("solver", ["padded", "plane", "padded_k5"])
def test_six_steps_from_scratch(run, solver):
    s = getattr(run, solver)
    boundary = run.tb_planes if solver == "plane" else run.tb
    carry = s.init_carry(run.t_state)
    for k in range(STEPS):
        carry, diag = s.simulate(carry, boundary, 1)
        jd = run.j_diags[k]
        assert diag.neighbor_drops == int(jd.neighbor_drops) == 0, k
        np.testing.assert_allclose(float(diag.dt), float(jd.dt), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(carry.time.dt),
                               float(run.j_carries[-1]["time.dt"]), rtol=1e-6)
    rows = live_rows(s.export_state(carry))
    assert rows.shape == run.j_final.shape == (run.n, 3)
    np.testing.assert_allclose(rows[:, :2], run.j_final[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows[:, 2], run.j_final[:, 2], rtol=1e-5, atol=1e-3)
    assert np.abs(rows[:, 2] - 100.0).max() > 1.0  # the pressure did real work


def test_plane_matches_padded(run):
    """Path (B) against path (A): same terms, same sequential order per query
    slot, so the two agree to f32 drift over the six steps."""
    pc = run.padded.init_carry(run.t_state)
    fc = run.plane.init_carry(run.t_state)
    pc, pd = run.padded.simulate(pc, run.tb, STEPS)
    fc, fd = run.plane.simulate(fc, run.tb_planes, STEPS)
    assert pd.neighbor_drops == fd.neighbor_drops == 0
    np.testing.assert_allclose(float(pc.time.dt), float(fc.time.dt), rtol=1e-6)
    prows = live_rows(run.padded.export_state(pc))
    frows = live_rows(run.plane.export_state(fc))
    np.testing.assert_allclose(frows[:, :2], prows[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(frows[:, 2], prows[:, 2], rtol=1e-5, atol=1e-3)
