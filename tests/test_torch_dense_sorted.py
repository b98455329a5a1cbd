"""The sorted carries: the port's DFSPHDenseSolver and WCSPHDenseSolver
(yasph2d_tpu_torch/models/dfsph_dense.py, models/wcsph_dense.py) on both pair
routes (the K3 twin with `use_pallas_slotmajor`, the K5 twin without) against
the JAX sorted solvers, jitted, on the CPU.

The scene is the contact scene of tests/test_torch_dfsph_padded.py (90 fluid
particles on a floor against a wall) with seeded 3 m/s velocities; DFSPH at
a fixed dt of 1/250 s (both loops iterate and warm-start), WCSPH at the
adaptive CFL 0.2. The sort and the slot grid are exact; the pair sums come in
the kernels' order (K3 per candidate, K5 per view) and XLA's, so the solvers
agree to f32 drift: per-step iterations, drops and dt equal (dt to rtol
1e-6), and the live rows (x, y, density) sorted by position within
positions atol 1e-5 and densities rtol 1e-5 / atol 1e-3.

- f32, with XSPH and with physical viscosity (mu = 0.01), 8 steps: both
  routes against the JAX sorted solver on its XLA route (the contract both
  JAX kernel routes are held to). The K3 route against the JAX sorted
  solver with `use_pallas_slotmajor` itself (its Pallas kernels in
  interpret mode, ~6 minutes to compile) is the `slow` test.
- bf16 (`pair_dtype="bfloat16"`, K5's bf16 math mode): against the JAX
  sorted solver's bf16 XLA route, jitted with XLA's
  `xla_allow_excess_precision` off (tests/test_torch_padded_bf16.py says why).
- `init_carry`: densities and alpha to rtol 1e-5, the slot grid equal.
- `rebuild_every = 1` is the default step bit for bit; `rebuild_every = 3`
  over 7 steps (two blocks, one leftover rebuild) against JAX's own blocking.
- dead padding particles (world.pad_particles_dense) leave the grid and stay
  frozen, as in JAX.
- A JAX carry's leaves (utils/interop.py) and checkpoints cross the packages,
  every leaf bit-equal; the runs from there agree.

The loop-gradient variants (`cache_loop_gradients`, `mxu_loop_gradients`)
and their refusals are tests/test_torch_loop_gradients.py's; the sharded
sorted route is tests/test_torch_shard_sorted.py's.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import yasph2d_tpu.utils.checkpoint as jckpt
import yasph2d_tpu.world as JW
import yasph2d_tpu_torch.world as TW
from test_torch_dfsph_padded import contact_scene
from test_torch_table_solvers import VISC, assert_runs_agree, counts, live_rows
from yasph2d_tpu.models.dfsph_dense import DFSPHDenseSolver as JDFSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHDenseSolver as JWCSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHDenseSolver as TDFSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHDenseSolver as TWCSPH
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils import checkpoint as tckpt
from yasph2d_tpu_torch.utils.interop import (
    dfsph_dense_carry_from_numpy,
    wcsph_dense_carry_from_numpy,
)

torch.set_num_threads(1)

STEPS = 8
NOISE = 3.0  # m/s
PAD = 16
EXACT_BF16 = {"xla_allow_excess_precision": False}
SOLVERS = {"dfsph": (JDFSPH, TDFSPH, JFixed(1.0 / 250.0), TFixed(1.0 / 250.0)),
           "wcsph": (JWCSPH, TWCSPH, JAdaptive(1 / 360, 1 / 24000, 0.2),
                     TAdaptive(1 / 360, 1 / 24000, 0.2))}
ROUTES = {"k3": True, "k5": False}  # route -> use_pallas_slotmajor
CASES = [(k, v, r) for k in SOLVERS for v in VISC for r in ROUTES]
IDS = ["-".join(c) for c in CASES]


def solver(side, kind, visc="xsph", slotmajor=False, pair_dtype="float32", **kw):
    """(world, solver, boundary) of one package (side 0 JAX, 1 the port)."""
    world = contact_scene((JW.FluidParticleWorld, TW.FluidParticleWorld)[side])
    h = world.properties.smoothing_length
    grid = dataclasses.replace(world.dense_grid(), use_pallas_slotmajor=slotmajor,
                               pair_dtype=pair_dtype)
    if side == 0 and slotmajor:
        grid = dataclasses.replace(grid, pallas_sm_row_block=4)
    s = SOLVERS[kind][side](viscosity_model=VISC[visc][side](h), properties=world.properties,
                            grid=grid, step_config=SOLVERS[kind][2 + side], **kw)
    boundary = world.boundary_dense(grid) if side == 0 else \
        world.boundary_dense(grid, device="cpu")
    return world, s, boundary


def noisy_state(side, world, pad=False):
    state = world.initial_state() if side == 0 else world.initial_state(device="cpu")
    if pad:
        state = (JW, TW)[side].pad_particles_dense(state, PAD, world.dense_grid())
    v = np.random.default_rng(42).normal(0.0, NOISE, tuple(state.velocities.shape))
    v = (v * np.asarray(state.alive)[:, None]).astype(np.float32)
    return state._replace(velocities=jax.numpy.asarray(v) if side == 0 else torch.as_tensor(v))


def init(side, s, state, boundary, kind, options=None):
    fn = jax.jit(s.init_carry, compiler_options=options) if side == 0 else s.init_carry
    return fn(state, boundary) if kind == "dfsph" else fn(state)


def run(side, s, carry, boundary, steps, options=None):
    simulate = (jax.jit(s.simulate, static_argnums=2, compiler_options=options)
                if side == 0 else s.simulate)
    per_step = []
    for _ in range(steps):
        carry, d = simulate(carry, boundary, 1)
        per_step.append(counts(d) + (float(d.dt),))
    return carry, per_step


@functools.lru_cache(maxsize=None)
def jax_run(kind, visc, slotmajor=False, pair_dtype="float32", pad=False):
    options = EXACT_BF16 if pair_dtype == "bfloat16" else None
    world, s, boundary = solver(0, kind, visc, slotmajor, pair_dtype)
    c0 = init(0, s, noisy_state(0, world, pad), boundary, kind, options)
    return c0, run(0, s, c0, boundary, STEPS, options)


def port_run(kind, visc, slotmajor=False, pair_dtype="float32", pad=False, steps=STEPS,
             **kw):
    world, s, boundary = solver(1, kind, visc, slotmajor, pair_dtype, **kw)
    c0 = init(1, s, noisy_state(1, world, pad), boundary, kind)
    return world, s, run(1, s, c0, boundary, steps)


@pytest.mark.parametrize("kind,visc,route", CASES, ids=IDS)
def test_sorted_solver_steps_match_jax(kind, visc, route):
    world, _, port = port_run(kind, visc, ROUTES[route])
    assert_runs_agree(port, jax_run(kind, visc)[1], world.num_dynamic_particles)
    if kind == "dfsph":
        assert max(s[0] for s in port[1]) > 1 and max(s[1] for s in port[1]) > 1
        assert float(port[0].ctx.sum_grad_stat.abs().sum()) > 0  # fluid at the walls


@pytest.mark.slow
@pytest.mark.parametrize("kind", list(SOLVERS))
def test_k3_route_matches_jax_slotmajor_solver(kind):
    world, _, port = port_run(kind, "xsph", True)
    assert_runs_agree(port, jax_run(kind, "xsph", True)[1], world.num_dynamic_particles)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_bf16_sorted_solver_matches_jax(kind):
    world, s, port = port_run(kind, "xsph", pair_dtype="bfloat16")
    assert s.grid.pair_dtype == "bfloat16" and not s.grid.use_pallas_slotmajor
    assert_runs_agree(port, jax_run(kind, "xsph", pair_dtype="bfloat16")[1],
                      world.num_dynamic_particles)
    # the mode is live: the f32 run differs
    f32_rows = live_rows(port_run(kind, "xsph")[2][0].particles)
    assert not np.array_equal(live_rows(port[0].particles), f32_rows)
    with pytest.raises(ValueError, match="bfloat16"):
        solver(1, kind, slotmajor=True, pair_dtype="bfloat16")


def test_dfsph_init_carry_matches_jax():
    jc = jax_run("dfsph", "xsph")[0]
    world, s, boundary = solver(1, "dfsph")
    tc = init(1, s, noisy_state(1, world), boundary, "dfsph")
    np.testing.assert_array_equal(tc.particles.positions.numpy(),
                                  np.asarray(jc.particles.positions))
    np.testing.assert_allclose(tc.particles.densities.numpy(),
                               np.asarray(jc.particles.densities), rtol=1e-5)
    np.testing.assert_allclose(tc.alpha.numpy(), np.asarray(jc.alpha), rtol=1e-5)
    for f in tc.ctx.slots._fields:
        np.testing.assert_array_equal(getattr(tc.ctx.slots, f).numpy(),
                                      np.asarray(getattr(jc.ctx.slots, f)), err_msg=f)
    np.testing.assert_array_equal(tc.v_pad.numpy()[tc.ctx.mask.numpy()],
                                  np.asarray(jc.v_pad)[np.asarray(jc.ctx.mask)])


def test_rebuild_every_one_is_the_default_step():
    default = port_run("dfsph", "xsph")[2]
    once = port_run("dfsph", "xsph", rebuild_every=1)[2]
    assert once[1] == default[1]
    for a, b in zip(once[0].particles, default[0].particles):
        assert torch.equal(a, b)


@pytest.mark.parametrize("route", list(ROUTES))
def test_rebuild_every_three_as_jax(route, monkeypatch):
    """7 steps with rebuild_every = 3: two blocks of a rebuilding step and two
    stale ones, then a leftover rebuild (3 sorts after init), against the JAX
    solver's own blocking (summed counts)."""
    from yasph2d_tpu_torch.models.slot_solver import SlotSolver

    calls = []
    sort = SlotSolver._sort
    monkeypatch.setattr(SlotSolver, "_sort", lambda self, *a: calls.append(1) or sort(self, *a))
    out = []
    for side in (0, 1):
        world, s, boundary = solver(side, "dfsph", slotmajor=side == 1 and ROUTES[route],
                                    rebuild_every=3)
        c = init(side, s, noisy_state(side, world), boundary, "dfsph")
        simulate = jax.jit(s.simulate, static_argnums=2) if side == 0 else s.simulate
        c, d = simulate(c, boundary, 7)
        out.append((c, [counts(d) + (float(d.dt),)]))
    assert len(calls) == 1 + 3
    assert_runs_agree(out[1], out[0], world.num_dynamic_particles)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_dead_particles_leave_the_grid_as_in_jax(kind):
    world, _, port = port_run(kind, "xsph", pad=True)
    assert_runs_agree(port, jax_run(kind, "xsph", pad=True)[1], world.num_dynamic_particles)
    p = port[0].particles
    assert int((~p.alive).sum()) > 0 and not p.velocities[~p.alive].any()


def carry_leaves(carry) -> dict:
    names, values, _ = jckpt._paths(carry)
    return {n.replace("/", "."): np.asarray(v) for n, v in zip(names, values)}


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_carries_cross_the_packages(tmp_path, kind):
    """The JAX carry after 4 steps (K5 route): its leaves through interop and
    its checkpoint load into the port, the port's checkpoint into JAX, every
    leaf bit-equal; then 4 more steps of each package agree."""
    jworld, js, jb = solver(0, kind, "physical")
    jc, _ = run(0, js, init(0, js, noisy_state(0, jworld), jb, kind), jb, 4)
    world, ts, tb = solver(1, kind, "physical")
    template = init(1, ts, noisy_state(1, world), tb, kind)

    convert = dfsph_dense_carry_from_numpy if kind == "dfsph" else wcsph_dense_carry_from_numpy
    converted = convert(carry_leaves(jc), device="cpu")
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jc)
    loaded = tckpt.load_checkpoint(jpath, template)
    saved = dict(np.load(jpath))
    if kind == "dfsph":
        assert "ctx/slots/inverse" in saved and "ctx/pos_pad" in saved
    for carry in (converted, loaded):
        port_leaves = {n: tckpt._to_numpy(v) for n, v in tckpt._leaves(carry)}
        assert sorted(port_leaves) == sorted(saved)
        for name, value in saved.items():
            np.testing.assert_array_equal(port_leaves[name], value, err_msg=name)
    tpath = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(tpath, loaded)
    jloaded = jckpt.load_checkpoint(tpath, jc)
    for name, value in carry_leaves(jloaded).items():
        np.testing.assert_array_equal(value, carry_leaves(jc)[name], err_msg=name)

    assert_runs_agree(run(1, ts, loaded, tb, 4), run(0, js, jloaded, jb, 4),
                      world.num_dynamic_particles)

