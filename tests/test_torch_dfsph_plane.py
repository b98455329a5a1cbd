"""The DFSPH plane step as a whole: the PyTorch port (its kernels' plain twins on
the CPU) against the JAX plane solver (interpret-mode kernels on the CPU), on
the tiny scene of tests/test_pallas_plane.py, and on a small contact scene
whose converted carry gets seeded random velocities so that both pressure
loops iterate and warm-start.

Tolerances: the ctx fields and one step from the same carry agree to rtol 1e-5
on live slots (same f32 ops in the same order; XLA contracts some multiply-adds
that PyTorch rounds separately). Over 6 steps from scratch, per-step iteration
and drop counts are equal and the sorted live rows agree to atol 1e-5, as in
tests/test_wcsph_plane.py."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_plane import DFSPHPlaneSolver as JSolver
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import boundary_from_numpy, carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STEPS = 6
CONFIGS = {
    "fixed": (JFixed(1.0 / 3000.0), TFixed(1.0 / 3000.0)),
    "adaptive": (JAdaptive(1 / 360, 1 / 24000, 1.5), TAdaptive(1 / 360, 1 / 24000, 1.5)),
}


def scene(world_cls):
    world = world_cls(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    return world


def carry_leaves(carry) -> dict:
    """The JAX plane carry's leaves as numpy, keyed as carry_from_numpy wants."""
    leaves = {f"ctx.{f}": np.asarray(getattr(carry.ctx, f)) for f in (
        "pos", "mask", "sum_grad_stat", "neighbor_total", "densities", "alpha",
        "num_dropped")}
    leaves.update({f: np.asarray(getattr(carry, f)) for f in (
        "v", "kappa", "stiff", "prev_density_iterations",
        "prev_divergence_iterations")})
    leaves.update({f"time.{f}": np.asarray(getattr(carry.time, f))
                   for f in carry.time._fields})
    return leaves


def live_rows(state):
    alive = np.asarray(state.alive)
    rows = np.concatenate(
        [np.asarray(state.positions), np.asarray(state.densities)[:, None]], axis=1
    )[alive]
    return rows[np.lexsort(rows.T)]


class Run:
    """One step configuration: both solvers, the JAX reference run (init carry,
    carry after step 1, per-step diagnostics, final state) computed once."""

    def __init__(self, config_name):
        jcfg, tcfg = CONFIGS[config_name]
        jw, tw = scene(JWorld), scene(TWorld)
        self.n = jw.num_dynamic_particles
        h = jw.properties.smoothing_length
        self.tgrid = dataclasses.replace(tw.dense_grid(occupancy=3),
                                         use_pallas_slotmajor=True)
        self.jgrid = dataclasses.replace(
            jw.dense_grid(occupancy=3), use_pallas_slotmajor=True, pallas_sm_row_block=4
        )
        self.js = JSolver(viscosity_model=JXSPH(h), properties=jw.properties,
                          grid=self.jgrid, step_config=jcfg)
        self.ts = TSolver(viscosity_model=TXSPH(h), properties=tw.properties,
                          grid=self.tgrid, step_config=tcfg)
        jdense = jw.boundary_dense(self.jgrid)
        self.jb = self.js.boundary_planes(jdense)
        self.tb = self.ts.boundary_planes(tw.boundary_dense(self.tgrid, device="cpu"))
        self.jb_leaves = {f: np.asarray(getattr(jdense, f)) for f in jdense._fields}
        self.t_state = tw.initial_state(device="cpu")

        c = jax.jit(self.js.init_carry)(jw.initial_state(), self.jb)
        self.j_init = carry_leaves(c)
        simulate = jax.jit(self.js.simulate, static_argnums=2)
        self.j_diags = []
        for k in range(STEPS):
            c, d = simulate(c, self.jb, 1)
            self.j_diags.append(d)
            if k == 0:
                self.j_step1 = carry_leaves(c)
        self.j_final = live_rows(self.js.export_state(c))


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    return Run(request.param)


def crop(run, a):
    return np.asarray(a)[..., :run.tgrid.ny, :run.tgrid.nx]


def test_init_ctx_matches(run):
    carry = run.ts.init_carry(run.t_state, run.tb)
    mask = carry.ctx.mask.numpy()
    np.testing.assert_array_equal(mask, crop(run, run.j_init["ctx.mask"]))
    assert mask.sum() == run.n
    assert int(carry.ctx.num_dropped) == int(run.j_init["ctx.num_dropped"]) == 0
    for field in ("densities", "alpha", "neighbor_total", "sum_grad_stat"):
        ours = getattr(carry.ctx, field).numpy()
        ref = crop(run, run.j_init[f"ctx.{field}"])
        live = np.broadcast_to(mask, ours.shape)
        np.testing.assert_allclose(ours[live], ref[live], rtol=1e-5, atol=0.0,
                                   err_msg=field)
    np.testing.assert_array_equal(carry.ctx.pos.numpy()[:, mask],
                                  crop(run, run.j_init["ctx.pos"])[:, mask])


def test_one_step_from_converted_carry(run):
    carry = carry_from_numpy(run.j_init, run.tgrid)
    boundary = boundary_from_numpy(run.jb_leaves)
    carry = carry._replace(time=carry.time.account_step())
    carry, diag = run.ts.step(carry, boundary)
    ref, jd = run.j_step1, run.j_diags[0]
    assert diag.density_iterations == int(jd.density_iterations)
    assert diag.divergence_iterations == int(jd.divergence_iterations)
    assert diag.neighbor_drops == int(jd.neighbor_drops) == 0
    np.testing.assert_allclose(float(diag.dt), float(jd.dt), rtol=1e-6)
    np.testing.assert_allclose(float(carry.time.dt), float(ref["time.dt"]), rtol=1e-6)
    mask = carry.ctx.mask.numpy()
    np.testing.assert_array_equal(mask, crop(run, ref["ctx.mask"]))
    for ours, key in ((carry.ctx.pos, "ctx.pos"), (carry.v, "v"),
                      (carry.ctx.densities, "ctx.densities")):
        ours = ours.numpy()
        live = np.broadcast_to(mask, ours.shape)
        np.testing.assert_allclose(ours[live], crop(run, ref[key])[live],
                                   rtol=1e-5, atol=0.0, err_msg=key)


def test_six_steps_from_scratch(run):
    carry = run.ts.init_carry(run.t_state, run.tb)
    for k in range(STEPS):
        carry, diag = run.ts.simulate(carry, run.tb, 1)
        jd = run.j_diags[k]
        assert diag.density_iterations == int(jd.density_iterations), k
        assert diag.divergence_iterations == int(jd.divergence_iterations), k
        assert diag.neighbor_drops == int(jd.neighbor_drops) == 0, k
    rows = live_rows(run.ts.export_state(carry))
    assert rows.shape == run.j_final.shape == (run.n, 3)
    np.testing.assert_allclose(rows[:, :2], run.j_final[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rows[:, 2], run.j_final[:, 2], rtol=1e-5, atol=1e-3)
    # warm start coverage: a step after the first saw prev iterations > 1
    assert any(int(d.density_iterations) > 1 for d in run.j_diags[:-1])


def contact_scene(world_cls):
    """90 fluid particles resting on a floor, against a wall."""
    world = world_cls(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def test_contact_scene_steps_match():
    """Seeded 3 m/s velocity noise and dt 1/250: the loops run 1-5 iterations
    per step with warm starts; from the same converted carry, per-step counts
    are equal and the live rows agree to rtol 1e-5."""
    jw, tw = contact_scene(JWorld), contact_scene(TWorld)
    h = jw.properties.smoothing_length
    jgrid = dataclasses.replace(jw.dense_grid(), use_pallas_slotmajor=True,
                                pallas_sm_row_block=4)
    tgrid = dataclasses.replace(tw.dense_grid(), use_pallas_slotmajor=True)
    js = JSolver(viscosity_model=JXSPH(h), properties=jw.properties, grid=jgrid,
                 step_config=JFixed(1.0 / 250.0))
    ts = TSolver(viscosity_model=TXSPH(h), properties=tw.properties, grid=tgrid,
                 step_config=TFixed(1.0 / 250.0))
    jdense = jw.boundary_dense(jgrid)
    jb = js.boundary_planes(jdense)
    c = jax.jit(js.init_carry)(jw.initial_state(), jb)
    noise = np.random.default_rng(42).normal(0.0, 3.0, c.v.shape).astype(np.float32)
    c = c._replace(v=jax.numpy.asarray(noise * np.asarray(c.ctx.mask)))
    carry = carry_from_numpy(carry_leaves(c), tgrid)
    boundary = boundary_from_numpy({f: np.asarray(getattr(jdense, f))
                                    for f in jdense._fields})
    simulate = jax.jit(js.simulate, static_argnums=2)
    counts_j, counts_t = [], []
    for _ in range(4):
        c, d = simulate(c, jb, 1)
        counts_j.append((int(d.density_iterations), int(d.divergence_iterations),
                         int(d.neighbor_drops)))
        carry, d = ts.simulate(carry, boundary, 1)
        counts_t.append((d.density_iterations, d.divergence_iterations,
                         d.neighbor_drops))
    assert counts_t == counts_j
    assert max(n for n, _, _ in counts_j) > 1 and max(n for _, n, _ in counts_j) > 1
    rows_j = live_rows(js.export_state(c))
    rows_t = live_rows(ts.export_state(carry))
    assert rows_t.shape == rows_j.shape == (jw.num_dynamic_particles, 3)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import yasph2d_tpu_torch, yasph2d_tpu_torch.scenes\n"
        "import yasph2d_tpu_torch.utils.interop, yasph2d_tpu_torch.ops.rebucket\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m.split('.')[0] == 'yasph2d_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
