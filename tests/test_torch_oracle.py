"""The port's table solvers against the independent NumPy oracles
(tools/oracle_dfsph.py, tools/oracle_wcsph.py): float32 DFSPH and WCSPH on
brute-force neighbour matrices, sharing no code, no neighbour structure and
no summation order with either package. The harnesses are the JAX package's
(tests/test_oracle_parity.py, tests/test_oracle_wcsph.py), run on the port's
CPU DFSPHSolver and WCSPHSolver on the same dam-break scene (the port's scene
API gives the JAX package's positions bit for bit).

- DFSPH at a fixed dt of 1/3000 s: both pressure loops' iteration counts
  equal the oracle's exactly every step (the early divergence warm-up spike
  included), the residuals within f32 drift (rtol 2e-3, atol 1e-4); the
  initial densities to atol 1e-3 and alpha to rtol 1e-5. SHORT_STEPS (6)
  steps here; the JAX test's 20 steps and its trajectory bound (positions
  within 2e-3, a small fraction of h = 0.067) in the `slow` test, as there.
- WCSPH over 25 steps at the adaptive CFL 0.2: the dt sequence (rtol 1e-4),
  max and mean density, max pressure, centre of mass, kinetic energy, and
  the final sorted positions (atol 2e-4), the JAX test's tolerances.

The JAX package's second WCSPH case, a fixed dt of 1/3000 s, is not held
here. In that run one fluid particle starts inside the left wall (the wall
spans x in [0.033, 0.133], the fluid starts at x = 0.1) and bounces off the
boundary particles at 17-30 m/s, which amplifies any rounding difference by
about 2x a step from step ~14. The port follows the JAX source's operation
order, and JAX run eagerly departs from the oracle exactly as the port does
(mean density 1.2e-5 relative at step 22, past the harness's 1e-5; port and
eager JAX within 2e-8 of each other); jitted JAX's reordered rounding
happens to track the oracle there (2e-7).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from test_oracle_wcsph import NUM_STEPS as WCSPH_STEPS  # noqa: E402
from tools.oracle_dfsph import OracleDFSPH  # noqa: E402
from tools.oracle_wcsph import make_oracle  # noqa: E402
from yasph2d_tpu_torch.models.dfsph import DFSPHSolver  # noqa: E402
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel  # noqa: E402
from yasph2d_tpu_torch.models.wcsph import WCSPHSolver  # noqa: E402
from yasph2d_tpu_torch.ops.slot_glue import tait_pressure  # noqa: E402
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep, FixedTimeStep  # noqa: E402
from yasph2d_tpu_torch.world import FluidParticleWorld  # noqa: E402

torch.set_num_threads(1)

DT = 1.0 / 3000.0
SHORT_STEPS = 6
LONG_STEPS = 20  # tests/test_oracle_parity.py NUM_STEPS


def dam_break_scene(particle_density=900.0):
    """tools/oracle_dfsph.py dam_break_scene, in the port's world."""
    world = FluidParticleWorld(2.0, particle_density, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 2.5), (2.0, 2.5), 4)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 4)
    world.add_boundary_thick_line((0.0, 0.0), (0.0, 2.5), 4)
    world.add_boundary_thick_line((2.0, 0.0), (2.0, 2.5), 4)
    world.add_boundary_thick_line((-2.0, -0.5), (4.0, -0.5), 4)
    return world


def test_scene_is_the_oracles():
    from tools.oracle_dfsph import dam_break_scene as jax_scene

    port, jax_world = dam_break_scene(), jax_scene()
    np.testing.assert_array_equal(port.host_positions(), jax_world.host_positions())
    np.testing.assert_array_equal(port.host_boundary_positions(),
                                  jax_world.host_boundary_positions())


def dfsph_parity(num_steps):
    world = dam_break_scene()
    oracle = OracleDFSPH(
        world.host_positions(), world.host_boundary_positions(),
        h=world.properties.smoothing_length,
        mass=world.properties.particle_mass, rho0=100.0, dt=DT,
    )
    solver = DFSPHSolver(
        viscosity_model=XSPHViscosityModel(smoothing_length=world.properties.smoothing_length),
        properties=world.properties, grid=world.grid, step_config=FixedTimeStep(DT),
    )
    boundary = world.boundary_grid(device="cpu")
    carry = solver.init_carry(world.initial_state(device="cpu"), boundary)

    np.testing.assert_allclose(np.sort(oracle.rho), np.sort(carry.particles.densities.numpy()),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.sort(oracle.alpha), np.sort(carry.alpha.numpy()), rtol=1e-5)

    iterations = []
    for i in range(num_steps):
        o = oracle.step()
        carry = carry._replace(time=carry.time.account_step())
        carry, d = solver.step(carry, boundary)
        assert o["density_iterations"] == d.density_iterations, f"step {i}"
        assert o["divergence_iterations"] == d.divergence_iterations, f"step {i}"
        np.testing.assert_allclose(float(d.avg_density_error), o["avg_density_error"],
                                   rtol=2e-3, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(d.avg_divergence), o["avg_divergence"],
                                   rtol=2e-3, atol=1e-4, err_msg=f"step {i}")
        iterations.append((d.density_iterations, d.divergence_iterations))
    return oracle, carry, iterations


def test_dfsph_iterations_match_oracle():
    _, _, iterations = dfsph_parity(SHORT_STEPS)
    assert max(n for _, n in iterations) > 1  # the divergence loop's warm-up spike


@pytest.mark.slow
def test_dfsph_residual_trajectories_match_oracle():
    oracle, carry, _ = dfsph_parity(LONG_STEPS)
    np.testing.assert_allclose(np.sort(carry.particles.positions.numpy(), axis=0),
                               np.sort(oracle.x, axis=0), rtol=0, atol=2e-3)


def aggregates(solver, carry):
    p = carry.particles
    alive = p.alive.numpy()
    pos, vel, rho = p.positions.numpy()[alive], p.velocities.numpy()[alive], \
        p.densities.numpy()[alive]
    m = solver.properties.particle_mass
    pressures = tait_pressure(solver.stiffness, solver.properties.fluid_density,
                              torch.as_tensor(rho)).numpy()
    return {
        "max_density": float(rho.max()),
        "mean_density": float(rho.mean(dtype=np.float64)),
        "max_pressure": float(pressures.max()),
        "com_x": float(pos[:, 0].mean(dtype=np.float64)),
        "com_y": float(pos[:, 1].mean(dtype=np.float64)),
        "kinetic_energy": float((0.5 * m * np.einsum("ik,ik->i", vel, vel))
                                .sum(dtype=np.float64)),
    }


def test_wcsph_adaptive_dt_matches_oracle():
    world = dam_break_scene()
    step_config = AdaptiveTimeStep(timestep_max=1.0 / 360.0, timestep_min=1.0 / 24000.0,
                                   cfl_factor=0.2)
    oracle = make_oracle(world, cfl_factor=0.2)
    solver = WCSPHSolver(
        viscosity_model=XSPHViscosityModel(smoothing_length=world.properties.smoothing_length),
        properties=world.properties, grid=world.grid, step_config=step_config,
    )
    boundary = world.boundary_grid(device="cpu")
    carry = solver.init_carry(world.initial_state(device="cpu"))

    for i in range(WCSPH_STEPS):
        o = oracle.step()
        carry = carry._replace(time=carry.time.account_step())
        carry, d = solver.step(carry, boundary)
        assert d.neighbor_drops == 0
        np.testing.assert_allclose(float(carry.time.dt), o["new_dt"], rtol=1e-4,
                                   err_msg=f"step {i}")
        agg = aggregates(solver, carry)
        np.testing.assert_allclose(agg["max_density"], o["max_density"], rtol=1e-4,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(agg["mean_density"], o["mean_density"], rtol=1e-5,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(agg["max_pressure"], o["max_pressure"], rtol=2e-3,
                                   atol=1e-3, err_msg=f"step {i}")
        np.testing.assert_allclose([agg["com_x"], agg["com_y"]], [o["com_x"], o["com_y"]],
                                   rtol=0, atol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(agg["kinetic_energy"], o["kinetic_energy"], rtol=1e-3,
                                   atol=1e-9, err_msg=f"step {i}")

    pos = carry.particles.positions.numpy()[carry.particles.alive.numpy()]
    np.testing.assert_allclose(pos[np.lexsort(pos.T)], oracle.x[np.lexsort(oracle.x.T)],
                               rtol=0, atol=2e-4)
