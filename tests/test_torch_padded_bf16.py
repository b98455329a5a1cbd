"""The padded solvers in bf16 (`pair_dtype="bfloat16"` on the K5 route: K5's
bf16 math mode, ops/pallas_pair.py) against the JAX padded solvers at the same
bf16 grid, whose pair passes are the XLA `dense_grid.pair_reduce` with
`relative=True`, on the contact scene of tests/test_torch_dfsph_padded.py
with seeded 3 m/s velocities (DFSPH: both loops iterate and warm-start;
WCSPH: adaptive CFL 0.2), 6 steps from the JAX init carry.

The JAX solvers run jitted with XLA's `xla_allow_excess_precision` off, so
that the CPU rounds every bf16 operation as the jaxpr types it (the TPU's
and the port's semantics). Then per-step iterations, drops and dt are
equal, and the live rows agree to f32 drift: positions to atol 1e-5 and
densities to rtol 1e-5 / atol 1e-3 (measured: 6e-8 and 0, summation order
only). With the default excess precision, XLA on the CPU keeps f32 through
the fused bf16 chains and drops most of the roundings: measured on the
XSPH DFSPH run, the first step's divergence loop then takes 4 iterations
where the per-op bf16 run takes 5, and the sorted positions part by up to
1.9 h over the 6 noisy steps, so that comparison would test XLA's fusion,
not the port.

Also: the bf16 step differs from the f32 step (the mode is live), and the
sorted positions of the two stay within JAX's own bf16-vs-f32 bound of 0.2 h
(tests/test_bf16_pairs.py:104-105) over 6 noisy steps; and the K3 route
still refuses bf16, as the JAX slot-major solvers assert.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_dfsph_padded import contact_scene, counts, leaves, live_rows
from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JDFSPH
from yasph2d_tpu.models.viscosity import PhysicalViscosityModel as JPhys
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JWCSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TDFSPH
from yasph2d_tpu_torch.models.viscosity import PhysicalViscosityModel as TPhys
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TWCSPH
from yasph2d_tpu_torch.ops import pallas_pair as tpp
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import (
    dfsph_padded_carry_from_numpy,
    wcsph_padded_carry_from_numpy,
)
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

STEPS = 6
NOISE = 3.0  # m/s
EXACT_BF16 = {"xla_allow_excess_precision": False}
# (solver, viscosity): the JAX and port classes and models, and step configs
VISC = {"xsph": (JXSPH, TXSPH), "physical": (lambda h: JPhys(h, fluid_viscosity=0.01),
                                             lambda h: TPhys(h, fluid_viscosity=0.01))}
SOLVERS = {"dfsph": (JDFSPH, TDFSPH, JFixed(1.0 / 250.0), TFixed(1.0 / 250.0)),
           "wcsph": (JWCSPH, TWCSPH, JAdaptive(1 / 360, 1 / 24000, 0.2),
                     TAdaptive(1 / 360, 1 / 24000, 0.2))}
CASES = [("dfsph", "xsph"), ("dfsph", "physical"), ("wcsph", "xsph"), ("wcsph", "physical")]
IDS = ["-".join(c) for c in CASES]


def port_solver(kind, visc, pair_dtype="bfloat16", use_pallas_slotmajor=False):
    world = contact_scene(TWorld)
    h = world.properties.smoothing_length
    grid = dataclasses.replace(world.dense_grid(), pair_dtype=pair_dtype,
                               use_pallas_slotmajor=use_pallas_slotmajor)
    _, cls, _, cfg = SOLVERS[kind]
    return world, cls(viscosity_model=VISC[visc][1](h), properties=world.properties,
                      grid=grid, step_config=cfg)


@functools.lru_cache(maxsize=None)
def jax_run(kind, visc):
    """The JAX bf16 padded solver's run (module docstring): its init carry's
    leaves with the seeded velocities, per-step (iterations, drops, dt) and
    the sorted live rows after STEPS steps."""
    world = contact_scene(JWorld)
    h = world.properties.smoothing_length
    grid = dataclasses.replace(world.dense_grid(), pair_dtype="bfloat16")
    cls, _, cfg, _ = SOLVERS[kind]
    solver = cls(viscosity_model=VISC[visc][0](h), properties=world.properties, grid=grid,
                 step_config=cfg)
    boundary = world.boundary_dense(grid)
    c = jax.jit(solver.init_carry, compiler_options=EXACT_BF16)(world.initial_state(),
                                                                  boundary)
    noise = np.random.default_rng(42).normal(0.0, NOISE, c.v_pad.shape).astype(np.float32)
    mask = np.asarray(c.ctx.mask if kind == "dfsph" else c.mask)[..., None]
    c = c._replace(v_pad=jax.numpy.asarray(noise * mask))
    init = leaves(c) if kind == "dfsph" else wcsph_leaves(c)
    simulate = jax.jit(solver.simulate, static_argnums=2, compiler_options=EXACT_BF16)
    per_step = []
    for _ in range(STEPS):
        c, d = simulate(c, boundary, 1)
        per_step.append(counts(d) + (float(d.dt),))
    return init, per_step, live_rows(solver.export_state(c))


def wcsph_leaves(carry) -> dict:
    out = {f: np.asarray(getattr(carry, f)) for f in carry._fields if f != "time"}
    out.update({f"time.{f}": np.asarray(getattr(carry.time, f))
                for f in carry.time._fields})
    return out


def port_run(solver, world, kind, init):
    """The port's solver from the converted JAX carry: per-step (iterations,
    drops, dt) and the sorted live rows."""
    carry = (dfsph_padded_carry_from_numpy if kind == "dfsph"
             else wcsph_padded_carry_from_numpy)(init, device="cpu")
    boundary = world.boundary_dense(solver.grid, device="cpu")
    per_step = []
    for _ in range(STEPS):
        carry, d = solver.simulate(carry, boundary, 1)
        per_step.append(counts(d) + (float(d.dt),))
    return per_step, live_rows(solver.export_state(carry))


@pytest.mark.parametrize("kind,visc", CASES, ids=IDS)
def test_bf16_padded_solver_matches_jax(kind, visc):
    world, solver = port_solver(kind, visc)
    init, jsteps, jrows = jax_run(kind, visc)
    steps, rows = port_run(solver, world, kind, init)
    assert [s[:3] for s in steps] == [s[:3] for s in jsteps]
    np.testing.assert_allclose([s[3] for s in steps], [s[3] for s in jsteps], rtol=1e-6)
    if kind == "dfsph":
        assert max(s[0] for s in steps) > 1 and max(s[1] for s in steps) > 1
    assert rows.shape == jrows.shape == (world.num_dynamic_particles, 3)
    np.testing.assert_allclose(rows[:, :2], jrows[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows[:, 2], jrows[:, 2], rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_bf16_step_is_live_and_near_f32(kind):
    """From the same noisy state the bf16 step differs from the f32 step on the
    K5 route, and its sorted positions stay within 0.2 h of f32's over 6
    steps; the bf16 solver runs K5's bf16 forms with the rounded constants."""
    rows = {}
    for dtype in ("float32", "bfloat16"):
        world, solver = port_solver(kind, "xsph", dtype)
        boundary = world.boundary_dense(solver.grid, device="cpu")
        state = world.initial_state(device="cpu")
        noise = np.random.default_rng(42).normal(0.0, NOISE, tuple(state.velocities.shape))
        state = state._replace(velocities=torch.as_tensor(noise.astype(np.float32)))
        carry = solver.init_carry(state, boundary)
        carry, d = solver.simulate(carry, boundary, STEPS)
        assert d.neighbor_drops == 0
        rows[dtype] = live_rows(solver.export_state(carry))
    forms = solver._forms
    assert solver._consts.radius_sq == tpp.bf16_float(solver.grid.radius_sq)
    assert all(f.term_fn.__qualname__.startswith("bf16_terms") for f in forms)
    h = world.properties.smoothing_length
    assert not np.array_equal(rows["bfloat16"], rows["float32"])
    for k in (0, 1):
        np.testing.assert_allclose(np.sort(rows["bfloat16"][:, k]),
                                   np.sort(rows["float32"][:, k]), rtol=0, atol=0.2 * h)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_k3_route_refuses_bf16(kind):
    with pytest.raises(ValueError, match="K3"):
        port_solver(kind, "xsph", use_pallas_slotmajor=True)
