"""The port's application layer (yasph2d_tpu_torch/app.py) against the JAX
package's (yasph2d_tpu/app.py), as a whole, on the CPU.

Both apps record the reference dam-break (`default_world`) in RECORDING mode at
160x120 with the default padded kind `dfsph_padded`: the port on `device="cpu"`
(the kernels' twins), JAX on its XLA route (the padded kind's default), jitted.
Both start from the same world (the scene API gives bit-identical positions).

- At 2500 particles/m^2, 3 recorded frames, held to the port's f32 drift
  tolerances: the steps each frame's `update()` runs equal (read before
  `draw()` resets them), the warnings equal (none), the simulated time after
  each frame to 1e-6 relative, the live positions after each frame to 1e-5
  absolute and the velocities to rtol 1e-4 plus 1e-5 of the largest speed
  (as tests/test_torch_dfsph_padded.py holds them), the frames within 0.1%
  of pixels; the port's renderer on JAX's exported live rows gives JAX's
  frame bit for bit.
- At 1600 particles/m^2 (the JAX package's own app test scene) the first
  step ejects one fluid particle at 100-200 m/s in both packages, which holds
  dt small (well over a hundred steps in the first frame) and makes the flow
  chaotic: the f32 rounding differences between the packages grow with the
  steps, past 1e-5 m within the first frame. So there the two apps' frame
  loops are held step by step over their first LOCKSTEP_STEPS steps, to the
  tolerances above (each dt to 1e-6 relative).
- The JAX app tests mirrored on the port's kinds (tests/test_render.py:86-200):
  reset, HUD text and overlay, the plane kinds' wiring; `device="cuda"`
  without a card raises.
- The table and sorted kinds (`dfsph`, the default as in the JAX app, and
  `wcsph`, `dfsph_dense`, `wcsph_dense`) build with the JAX app's solver
  class, grid, boundary and CFL, and their first steps agree with the JAX
  app's (400 particles/m^2, the tolerances above).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import yasph2d_tpu.app as J
import yasph2d_tpu_torch.app as T
from yasph2d_tpu_torch.config import KINDS

KIND = "dfsph_padded"
RESOLUTION = (160, 120)
FRAMES = 3
LOCKSTEP_STEPS = 30


def make_app(mod, density, directory, **kw):
    return mod.SimulationApp(solver=KIND, world=mod.default_world(density),
                             resolution=RESOLUTION, update_mode=mod.UpdateMode.RECORDING,
                             recording_dir=str(directory), **kw)


def matched(ref_positions, positions):
    """Each particle's distance to its nearest reference particle and that
    particle's index; the matching must be one to one."""
    dist, idx = cKDTree(ref_positions).query(positions)
    assert len(np.unique(idx)) == len(idx), "the nearest-particle matching is not 1:1"
    return dist, idx


def assert_state_close(ref, port):
    """Live positions to 1e-5 absolute; velocities to rtol 1e-4 plus 1e-5 of
    the largest speed (tests/test_torch_dfsph_padded.py's velocity bound)."""
    (pj, vj), (pt, vt) = ref, port
    assert pt.shape == pj.shape
    dist, idx = matched(pj, pt)
    assert dist.max() <= 1e-5, f"positions differ by up to {dist.max()}"
    scale = max(float(np.abs(vj).max()), 1.0)
    np.testing.assert_allclose(vt, vj[idx], rtol=1e-4, atol=1e-5 * scale)


def pixel_mismatch(a, b):
    return float((a != b).any(axis=-1).mean())


class Run:
    """FRAMES frames of an app's loop: the steps each update() ran, read
    before draw() resets them, the frames, and (simulated time, live state)
    after each frame."""

    def __init__(self, app):
        self.app, self.steps, self.images, self.frames = app, [], [], []
        for _ in range(FRAMES):
            app.update()
            self.steps.append(app.time_manager.num_simulation_steps_this_frame)
            self.images.append(app.draw())
            self.frames.append((app.time_manager.total_simulated_time, app.particle_state()))
        assert app.recorder.flush() == 0
        self.total, self.state = self.frames[-1]
        self.last_dt = app.time_manager.simulation_step
        self.warnings = list(app.warnings)


def first_steps(app, n):
    """(dt, live state) after each of the app's first `n` solver steps, run
    as its frame loop runs them (`update()`, stopped after `n` steps)."""
    app.time_manager.force_frame_delta(1.0 / 60.0)
    states = []
    while len(states) < n:
        assert app.time_manager.simulation_frame_loop().name == "PERFORM_STEP_AND_CALL_AGAIN"
        app.single_sim_step()
        states.append((app.time_manager.simulation_step, app.particle_state()))
    return states


@pytest.fixture(scope="module")
def chaotic(tmp_path_factory):
    """Both apps at 1600 particles/m^2: the state after each of the first
    LOCKSTEP_STEPS steps."""
    tmp = tmp_path_factory.mktemp("app1600")
    return list(zip(first_steps(make_app(J, 1600.0, tmp / "jax"), LOCKSTEP_STEPS),
                    first_steps(make_app(T, 1600.0, tmp / "port", device="cpu"),
                                LOCKSTEP_STEPS)))


@pytest.fixture(scope="module")
def calm(tmp_path_factory):
    """Both apps at 2500 particles/m^2, FRAMES recorded frames."""
    tmp = tmp_path_factory.mktemp("app2500")
    return {"jax": Run(make_app(J, 2500.0, tmp / "jax")),
            "port": Run(make_app(T, 2500.0, tmp / "port", device="cpu"))}


def test_same_world():
    j, t = J.default_world(1600.0), T.default_world(1600.0)
    np.testing.assert_array_equal(t.host_positions(), j.host_positions())
    np.testing.assert_array_equal(t.host_boundary_positions(), j.host_boundary_positions())


def test_lockstep_steps_match_jax(chaotic):
    assert len(chaotic) == LOCKSTEP_STEPS
    for i, ((jdt, jstate), (tdt, tstate)) in enumerate(chaotic):
        assert abs(tdt - jdt) <= 1e-6 * jdt, (i, tdt, jdt)
        assert_state_close(jstate, tstate)
    # the ejected particle: 100-200 m/s after the first step
    speed = np.linalg.norm(chaotic[0][0][1][1], axis=1).max()
    assert 100.0 < speed < 200.0


def test_recorded_frames_steps_match_jax(calm):
    j, t = calm["jax"], calm["port"]
    assert t.steps == j.steps and sum(t.steps) > FRAMES
    assert t.warnings == j.warnings == []
    assert t.app.time_manager.num_frames_rendered == j.app.time_manager.num_frames_rendered
    assert t.app.time_manager.num_simulation_steps == j.app.time_manager.num_simulation_steps
    for run in (j, t):
        files = sorted(p.name for p in Path(run.app.recorder.directory).iterdir())
        assert files == sorted(f"{i}.png" for i in range(FRAMES))


def test_recorded_frames_clock_matches_jax(calm):
    """Recording forces 1/60 s frames: after FRAMES frames (and the trailing
    wall-clock delta the next update() overwrites, as in the reference) both
    clocks stand within one dt below the same frame boundary, and agree to
    1e-6 relative."""
    boundary = (FRAMES + 1) / 60.0
    for run in calm.values():
        assert boundary - run.last_dt - 1e-6 <= run.total <= boundary + 1e-6, run.total
    j, t = calm["jax"], calm["port"]
    assert abs(t.total - j.total) <= 1e-6 * j.total


def test_recorded_frames_state_matches_jax(calm):
    (pj, vj), (pt, vt) = calm["jax"].state, calm["port"].state
    assert pt.shape == pj.shape == (calm["port"].app.world.num_dynamic_particles, 2)
    for p, v in ((pj, vj), (pt, vt)):
        assert np.isfinite(p).all() and np.isfinite(v).all()
    # every particle still in the closed tank
    assert ((pt > (-2.1, -0.6)) & (pt < (4.1, 2.6))).all()
    assert_state_close((pj, vj), (pt, vt))


def test_recorded_frames_pixels_match_jax(calm):
    j, t = calm["jax"], calm["port"]
    for a, b in zip(t.images, j.images):
        assert a.shape == (RESOLUTION[1], RESOLUTION[0], 3) and a.dtype == np.uint8
        assert pixel_mismatch(a, b) < 0.001
    # the port's renderer on JAX's exported rows draws JAX's frame
    ours = t.app.renderer.render(*j.state, boundary_positions=t.app._boundary_render_positions)
    np.testing.assert_array_equal(ours, j.images[-1])


def test_calm_frames_match_jax(calm):
    """The simulated time and the live state after every frame, not only the
    last."""
    j, t = calm["jax"], calm["port"]
    assert len(t.frames) == len(j.frames) == FRAMES
    for (jt, jstate), (tt, tstate) in zip(j.frames, t.frames):
        assert abs(tt - jt) <= 1e-6 * jt
        assert_state_close(jstate, tstate)


def test_app_reset(tmp_path):
    """tests/test_render.py:86-97 on the port (wcsph_padded, the WCSPH kind)."""
    app = T.SimulationApp(solver="wcsph_padded", world=T.default_world(1600.0),
                          resolution=(64, 64), update_mode=T.UpdateMode.RECORDING,
                          recording_dir=str(tmp_path / "r"), device="cpu")
    app.time_manager.force_frame_delta(1.0 / 60.0)
    for _ in range(3):
        app.time_manager.simulation_frame_loop()
        app.single_sim_step()
    assert app.time_manager.num_simulation_steps > 0
    app.reset_simulation()
    assert app.time_manager.num_simulation_steps == 0
    assert float(app.carry.time.total_simulated_time) == 0.0


def test_hud_text_and_overlay(calm):
    """tests/test_render.py:157-171 on the port's calm run: the HUD names its
    statistics and paints near-white text from (8, 8) down its lines only
    (PIL's default font is anti-aliased, so its strokes peak near 255)."""
    app = calm["port"].app
    plain = app.renderer.render(*app.particle_state(),
                                boundary_positions=app._boundary_render_positions)
    app.show_hud = True
    try:
        image = app.draw()
    finally:
        app.show_hud = False
    text = app.hud_text()
    assert "steps/frame" in text and "dt:" in text and "simulated:" in text
    changed = (image != plain).any(axis=-1)
    rows, cols = np.nonzero(changed)
    lines = text.count("\n") + 1
    assert rows.size and min(rows.min(), cols.min()) >= 4 and rows.max() < 8 + 16 * lines
    assert (image[changed].min(axis=-1) >= 200).any()


@pytest.mark.parametrize("kind", ["wcsph_plane", "dfsph_plane"])
def test_app_plane_solver_wiring(kind):
    """tests/test_render.py:188-200: the plane kinds build the plane-form
    boundary and carry, and the render path exports live state from it."""
    world = T.default_world(particle_density=400.0)
    app = T.SimulationApp(solver=kind, world=world, resolution=(64, 64), device="cpu")
    assert app.solver.grid.use_pallas_slotmajor
    assert hasattr(app.boundary, "geom")  # BoundaryPlanes, not BoundaryDense
    positions, velocities = app.particle_state()
    assert positions.shape[0] == world.num_dynamic_particles
    assert np.isfinite(positions).all() and np.isfinite(velocities).all()


@pytest.mark.parametrize("kind", ["dfsph_padded", "wcsph_padded"])
def test_app_padded_wiring_takes_the_k5_route(kind):
    app = T.SimulationApp(solver=kind, world=T.default_world(400.0), resolution=(64, 64),
                          device="cpu")
    assert not app.solver.grid.use_pallas_slotmajor and app.solver.grid.occupancy == 8
    assert not hasattr(app.boundary, "geom")
    assert app.solver.step_config.cfl_factor == (1.5 if kind.startswith("dfsph") else 0.2)


@pytest.mark.parametrize("kind", ["dfsph", "dfsph_dense", "wcsph", "wcsph_dense"])
def test_table_kinds_raise(kind):
    """The table and sorted kinds, which the port once refused, build as the
    JAX app builds them and step with it: each app's first three steps as its
    frame loop runs them (`first_steps`) from the same world, the per-step dt
    and the live state after each step within the tolerances above."""
    apps = [mod.SimulationApp(solver=kind, world=mod.default_world(400.0),
                              resolution=(64, 64), **kw)
            for mod, kw in ((J, {}), (T, dict(device="cpu")))]
    jax_app, app = apps
    assert type(app.solver).__name__ == KINDS[kind][0] == type(jax_app.solver).__name__
    assert app.solver.step_config.cfl_factor == jax_app.solver.step_config.cfl_factor
    assert type(app.boundary).__name__ == type(jax_app.boundary).__name__
    if kind.endswith("_dense"):
        assert app.solver.grid.occupancy == 8 and not app.solver.grid.use_pallas_slotmajor
    for (jdt, jstate), (dt, state) in zip(first_steps(jax_app, 3), first_steps(app, 3)):
        np.testing.assert_allclose(dt, jdt, rtol=1e-6)
        assert_state_close(jstate, state)
    assert not app.warnings and not jax_app.warnings


def test_default_kind_is_dfsph_padded():
    """The default kind is the JAX app's: the table `dfsph` (main.rs:91), on
    the world's cell grid and boundary_grid."""
    app = T.SimulationApp(world=T.default_world(400.0), resolution=(64, 64), device="cpu")
    assert app.solver_name == "dfsph"
    assert type(app.solver).__name__ == "DFSPHSolver"
    assert app.solver.grid == app.world.grid and hasattr(app.boundary, "keys")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.SimulationApp(world=T.default_world(400.0))
