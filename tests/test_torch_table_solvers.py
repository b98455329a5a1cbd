"""The table solvers: the port's DFSPHSolver and WCSPHSolver
(yasph2d_tpu_torch/models/dfsph.py, models/wcsph.py) against the JAX
package's, jitted, on the CPU.

The scene is the contact scene of tests/test_torch_dfsph_plane.py (90 fluid
particles on a floor against a wall) with seeded 3 m/s velocities, so that
both DFSPH loops iterate and warm-start and the boundary table is in use.
The neighbour tables are JAX's bit for bit (tests/test_torch_neighborhood.py);
the sums over K come in torch's order and XLA's, so the solvers agree to f32
drift:

- `init_carry`: densities to rtol 1e-6, alpha to rtol 1e-5, the tables equal;
- 15 steps (fixed dt 1/250 for DFSPH; adaptive CFL 0.2 for WCSPH), with
  XSPH and with physical viscosity (mu = 0.01): per-step iterations, drops
  and dt equal (dt to rtol 1e-6), and the live rows (x, y, density) sorted
  by position within positions atol 1e-5 and densities rtol 1e-5 / atol
  1e-3;
- with dead padding particles (world.pad_particles_dense) the same, and
  the dead rows frozen;
- a JAX carry's leaves become the port's (utils/interop.py), and a
  checkpoint of either package's carry loads in the other, every leaf
  bit-equal; the runs from there agree as above.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import yasph2d_tpu.utils.checkpoint as jckpt
import yasph2d_tpu.world as JW
import yasph2d_tpu_torch.world as TW
from test_torch_dfsph_padded import contact_scene
from yasph2d_tpu.models.dfsph import DFSPHSolver as JDFSPH
from yasph2d_tpu.models.viscosity import PhysicalViscosityModel as JPhys
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph import WCSPHSolver as JWCSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu_torch.models.dfsph import DFSPHSolver as TDFSPH
from yasph2d_tpu_torch.models.viscosity import PhysicalViscosityModel as TPhys
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph import WCSPHSolver as TWCSPH
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils import checkpoint as tckpt
from yasph2d_tpu_torch.utils.interop import (
    dfsph_table_carry_from_numpy,
    wcsph_table_carry_from_numpy,
)

torch.set_num_threads(1)

STEPS = 15
NOISE = 3.0  # m/s
PAD = 16  # pad the particle count to a multiple of this (dead particles)
VISC = {"xsph": (JXSPH, TXSPH), "physical": (lambda h: JPhys(h, fluid_viscosity=0.01),
                                             lambda h: TPhys(h, fluid_viscosity=0.01))}
SOLVERS = {"dfsph": (JDFSPH, TDFSPH, JFixed(1.0 / 250.0), TFixed(1.0 / 250.0)),
           "wcsph": (JWCSPH, TWCSPH, JAdaptive(1 / 360, 1 / 24000, 0.2),
                     TAdaptive(1 / 360, 1 / 24000, 0.2))}
CASES = [("dfsph", "xsph"), ("dfsph", "physical"), ("wcsph", "xsph"), ("wcsph", "physical")]
IDS = ["-".join(c) for c in CASES]


def solvers(kind, visc):
    """(JAX world, solver, boundary), (port world, solver, boundary)."""
    out = []
    for side, world_cls in enumerate((JW.FluidParticleWorld, TW.FluidParticleWorld)):
        world = contact_scene(world_cls)
        h = world.properties.smoothing_length
        cls, cfg = SOLVERS[kind][side], SOLVERS[kind][2 + side]
        solver = cls(viscosity_model=VISC[visc][side](h), properties=world.properties,
                     grid=world.grid, step_config=cfg)
        boundary = world.boundary_grid() if side == 0 else world.boundary_grid(device="cpu")
        out.append((world, solver, boundary))
    return out


def noisy_states(jworld, tworld, pad=False):
    """Both worlds' initial states with the same seeded velocities (and
    dead padding particles, with `pad`)."""
    js, ts = jworld.initial_state(), tworld.initial_state(device="cpu")
    if pad:
        js = JW.pad_particles_dense(js, PAD, jworld.dense_grid())
        ts = TW.pad_particles_dense(ts, PAD, tworld.dense_grid())
    v = np.random.default_rng(42).normal(0.0, NOISE, tuple(ts.velocities.shape))
    v = (v * np.asarray(ts.alive)[:, None]).astype(np.float32)
    return (js._replace(velocities=jax.numpy.asarray(v)),
            ts._replace(velocities=torch.as_tensor(v)))


def init(solver, state, boundary, kind, jax_side):
    if kind == "dfsph":
        return (jax.jit(solver.init_carry) if jax_side else solver.init_carry)(state, boundary)
    return solver.init_carry(state)


def counts(d):
    return (int(d.density_iterations), int(d.divergence_iterations), int(d.neighbor_drops))


def live_rows(particles) -> np.ndarray:
    alive = np.asarray(particles.alive)
    rows = np.concatenate([np.asarray(particles.positions),
                           np.asarray(particles.densities)[:, None]], axis=1)[alive]
    return rows[np.lexsort(rows.T)]


def run(solver, carry, boundary, steps, jax_side):
    simulate = jax.jit(solver.simulate, static_argnums=2) if jax_side else solver.simulate
    per_step = []
    for _ in range(steps):
        carry, d = simulate(carry, boundary, 1)
        per_step.append(counts(d) + (float(d.dt),))
    return carry, per_step


def assert_runs_agree(port, ref, n_live):
    (pcarry, psteps), (jcarry, jsteps) = port, ref
    assert [s[:3] for s in psteps] == [s[:3] for s in jsteps]
    np.testing.assert_allclose([s[3] for s in psteps], [s[3] for s in jsteps], rtol=1e-6)
    prows, jrows = live_rows(pcarry.particles), live_rows(jcarry.particles)
    assert prows.shape == jrows.shape == (n_live, 3)
    np.testing.assert_allclose(prows[:, :2], jrows[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(prows[:, 2], jrows[:, 2], rtol=1e-5, atol=1e-3)


@functools.lru_cache(maxsize=None)
def jax_run(kind, visc, pad=False):
    (jw, js, jb), (tw, _, _) = solvers(kind, visc)
    jstate, _ = noisy_states(jw, tw, pad)
    c0 = init(js, jstate, jb, kind, True)
    return c0, run(js, c0, jb, STEPS, True)


def test_dfsph_init_carry_matches_jax():
    (jw, js, jb), (tw, ts, tb) = solvers("dfsph", "xsph")
    jstate, tstate = noisy_states(jw, tw)
    jc, tc = init(js, jstate, jb, "dfsph", True), init(ts, tstate, tb, "dfsph", False)
    np.testing.assert_array_equal(tc.particles.positions.numpy(),
                                  np.asarray(jc.particles.positions))
    np.testing.assert_allclose(tc.particles.densities.numpy(),
                               np.asarray(jc.particles.densities), rtol=1e-6)
    np.testing.assert_allclose(tc.alpha.numpy(), np.asarray(jc.alpha), rtol=1e-5)
    for table in ("dynamic", "static"):
        for f in ("idx", "mask", "count", "num_dropped"):
            np.testing.assert_array_equal(
                getattr(getattr(tc.neighborhood, table), f).numpy(),
                np.asarray(getattr(getattr(jc.neighborhood, table), f)))
    assert (tc.prev_density_iterations, tc.prev_divergence_iterations) == (1, 0)


@pytest.mark.parametrize("kind,visc", CASES, ids=IDS)
def test_table_solver_steps_match_jax(kind, visc):
    (jw, _, _), (tw, ts, tb) = solvers(kind, visc)
    _, tstate = noisy_states(jw, tw)
    _, ref = jax_run(kind, visc)
    port = run(ts, init(ts, tstate, tb, kind, False), tb, STEPS, False)
    assert_runs_agree(port, ref, tw.num_dynamic_particles)
    if kind == "dfsph":  # both loops iterated, so both warm starts ran
        assert max(s[0] for s in port[1]) > 1 and max(s[1] for s in port[1]) > 1
        # the noise has thrown fluid against the boundary
        assert int(port[0].neighborhood.static.count.sum()) > 0


@pytest.mark.parametrize("kind", ["dfsph", "wcsph"])
def test_dead_particles_stay_frozen_as_in_jax(kind):
    (jw, _, _), (tw, ts, tb) = solvers(kind, "xsph")
    _, tstate = noisy_states(jw, tw, pad=True)
    assert not bool(tstate.alive.all())
    _, ref = jax_run(kind, "xsph", True)
    port = run(ts, init(ts, tstate, tb, kind, False), tb, STEPS, False)
    assert_runs_agree(port, ref, tw.num_dynamic_particles)
    p = port[0].particles
    dead = ~p.alive
    assert int(dead.sum()) == int((~tstate.alive).sum())
    assert not p.velocities[dead].any()  # frozen: no gravity, no advection


def carry_leaves(carry) -> dict:
    names, values, _ = jckpt._paths(carry)
    return {n.replace("/", "."): np.asarray(v) for n, v in zip(names, values)}


@pytest.mark.parametrize("kind", ["dfsph", "wcsph"])
def test_carries_cross_the_packages(tmp_path, kind):
    """A JAX carry after 5 steps: its leaves through interop, and its
    checkpoint, load into the port; the port's checkpoint loads into JAX;
    every leaf bit-equal; then 5 more steps of each package agree."""
    (jw, js, jb), (tw, ts, tb) = solvers(kind, "physical")
    jstate, tstate = noisy_states(jw, tw)
    jc, _ = run(js, init(js, jstate, jb, kind, True), jb, 5, True)
    template = init(ts, tstate, tb, kind, False)

    convert = dfsph_table_carry_from_numpy if kind == "dfsph" else wcsph_table_carry_from_numpy
    converted = convert(carry_leaves(jc), device="cpu")
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jc)
    loaded = tckpt.load_checkpoint(jpath, template)
    saved = dict(np.load(jpath))
    if kind == "dfsph":
        assert "neighborhood/static/num_dropped" in saved
    for carry in (converted, loaded):
        port_leaves = {n: tckpt._to_numpy(v) for n, v in tckpt._leaves(carry)}
        assert sorted(port_leaves) == sorted(saved)
        for name, value in saved.items():
            assert port_leaves[name].dtype == value.dtype or value.ndim == 0, name
            np.testing.assert_array_equal(port_leaves[name], value, err_msg=name)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(tpath, loaded)
    jloaded = jckpt.load_checkpoint(tpath, jc)
    for name, value in carry_leaves(jloaded).items():
        np.testing.assert_array_equal(value, carry_leaves(jc)[name], err_msg=name)

    assert_runs_agree(run(ts, loaded, tb, 5, False), run(js, jloaded, jb, 5, True),
                      tw.num_dynamic_particles)
