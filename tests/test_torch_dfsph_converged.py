"""The port's DFSPHPaddedSolver against the JAX package's under the knobs of
the benchmark's `dfsph_converged_f32` configuration
(portbench/configs/dfsph_converged_f32.json: CFL 0.75 and a density
tolerance of 1e-8 s, the DFSPH papers' 0.01% of rho0 a step at the 1M
cell's dt), on a small double dam-break from rest through its first
impact on the floor.

Both run step by step from their own init, the JAX solver eagerly
(`jax.disable_jit`, so that it keeps its source's order of operations, as
the port does: the ROADMAP's comparison rules), the port on the K5 + K4
twins. At ~1000 particles the impact comes at step 27, and the density loop
iterates 3-17 times in its first four steps, with warm starts. Per step the
density and divergence iterations and the drops are equal and dt agrees to
rtol 1e-6; the live rows (sorted positions and densities) end within f32
drift, the tolerances of tests/test_torch_dfsph_padded.py."""

import json
from pathlib import Path

import jax
import numpy as np
import pytest

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JSolver
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

from test_torch_dfsph_padded import assert_rows_close, counts, live_rows

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench/configs/dfsph_converged_f32.json").read_text())
KNOBS = ("max_avg_density_error", "max_density_iterations", "max_divergence_error",
         "max_divergence_iterations")
PARTICLES = 1000
OCCUPANCY = 7  # the cell's slots a cell
STEPS = 31  # through the impact at step 27 (0-based)


def double_dam_break(world_cls, target_particles):
    """The double dam-break of portbench/scenes/double_dam_break.json."""
    world = world_cls(2.0, target_particles / (2 * 0.8 * 1.2 * 0.81), 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.8, 1.2), 0.05)
    world.add_fluid_rect((3.1, 0.05, 0.8, 1.2), 0.05)
    for start, end, thickness in [((0.0, 0.0), (4.0, 0.0), 3), ((0.0, 2.5), (0.0, 0.0), 3),
                                  ((4.0, 0.0), (4.0, 2.5), 3), ((4.0, 2.5), (0.0, 2.5), 3),
                                  ((1.7, 0.0), (1.7, 0.45), 2), ((1.7, 0.45), (2.3, 0.45), 2),
                                  ((2.3, 0.45), (2.3, 0.0), 2)]:
        world.add_boundary_thick_line(start, end, thickness)
    return world


def solver_args(world, step_cls):
    t = CONFIG["timestep"]
    h = world.properties.smoothing_length
    return dict(properties=world.properties, grid=world.dense_grid(occupancy=OCCUPANCY),
                step_config=step_cls(t["timestep_max"], t["timestep_min"], t["cfl_factor"]),
                **{k: CONFIG["solver"][k] for k in KNOBS}), h


@pytest.fixture(scope="module")
def runs():
    jw, tw = double_dam_break(JWorld, PARTICLES), double_dam_break(TWorld, PARTICLES)
    jargs, h = solver_args(jw, JAdaptive)
    targs, _ = solver_args(tw, TAdaptive)
    js = JSolver(viscosity_model=JXSPH(h, CONFIG["viscosity"]["xsph_epsilon"]), **jargs)
    ts = TSolver(viscosity_model=TXSPH(h, CONFIG["viscosity"]["xsph_epsilon"]), **targs)
    out = {}
    with jax.disable_jit():
        jb = jw.boundary_dense(js.grid)
        c = js.init_carry(jw.initial_state(), jb)
        diags = []
        for _ in range(STEPS):
            c, d = js.simulate(c, jb, 1)
            diags.append(counts(d) + (float(d.dt),))
        out["jax"] = diags, live_rows(js.export_state(c))
    tb = tw.boundary_dense(ts.grid, device="cpu")
    c = ts.init_carry(tw.initial_state(device="cpu"), tb)
    diags = []
    for _ in range(STEPS):
        c, d = ts.simulate(c, tb, 1)
        diags.append(counts(d) + (float(d.dt),))
    out["port"] = diags, live_rows(ts.export_state(c))
    out["n"] = tw.num_dynamic_particles
    return out


def test_knobs_are_the_configurations():
    s = CONFIG["solver"]
    assert (s["kind"], s["use_pallas_slotmajor"], s["pair_dtype"]) == (
        "dfsph_padded", False, "float32")
    assert CONFIG["viscosity"]["kind"] == "xsph"


def test_iterations_equal_every_step_through_the_impact(runs):
    (port, _), (ref, _) = runs["port"], runs["jax"]
    for k, (ours, theirs) in enumerate(zip(port, ref)):
        assert ours[:3] == theirs[:3], k
        np.testing.assert_allclose(ours[3], theirs[3], rtol=1e-6, err_msg=str(k))
    density = [d[0] for d in ref]
    # the impact: the density loop iterates, and the next steps warm-start
    assert max(density) > 5 and sum(n > 1 for n in density) >= 3
    assert all(d[2] == 0 for d in ref)


def test_live_rows_after_the_impact(runs):
    assert_rows_close(runs["port"][1], runs["jax"][1], runs["n"])
