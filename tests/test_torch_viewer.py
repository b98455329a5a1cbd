"""The port's interactive viewer (yasph2d_tpu_torch/viewer.py) driven headlessly
on Agg, as tests/test_viewer.py drives the JAX package's.

No display exists in CI, so the window itself can't open; these tests drive the
same code paths the live window runs against the port's app on the CPU:
construction, frame ticks through the TimeManager governor, the velocity-heatmap
scatter update, and the reference's key bindings (Esc/Space/R/H,
main.rs:302-337) via synthesized key events, with the R retarget of
`TimeState.target_frame_length` on the host clock. The port does not jit, so
there is no recompile count to hold. The `slow` marks are tests/test_viewer.py's.
"""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg", force=True)

from yasph2d_tpu_torch.app import SimulationApp, UpdateMode, default_world  # noqa: E402
from yasph2d_tpu_torch.viewer import InteractiveViewer  # noqa: E402


class _Key:
    def __init__(self, key):
        self.key = key


def _app():
    # the viewer's own default density (viewer.main): at tests/test_viewer.py's
    # 400 particles/m^2 the reference walls overlap the fluid, the first steps
    # eject particles at hundreds of m/s and hold dt near its floor, so each
    # realtime tick (1/30 s of simulated time) would run hundreds of steps of
    # the CPU twins
    return SimulationApp(solver="dfsph_padded", world=default_world(2500.0), device="cpu")


@pytest.fixture(scope="module")
def viewer():
    return InteractiveViewer(_app(), figsize=(4, 3))


@pytest.mark.slow
def test_viewer_ticks_and_updates_scatter(viewer):
    for _ in range(2):
        viewer.tick()
    offsets = np.asarray(viewer.scatter.get_offsets())
    assert offsets.shape[0] == viewer.app.world.num_dynamic_particles
    assert np.isfinite(offsets).all()
    colors = np.asarray(viewer.scatter.get_facecolor())
    assert colors.shape[0] == offsets.shape[0]


@pytest.mark.slow
def test_space_resets_simulation(viewer):
    viewer.tick()
    t_before = viewer.app.time_manager.total_simulated_time
    assert t_before > 0.0
    viewer.on_key(_Key(" "))
    assert viewer.app.time_manager.total_simulated_time == 0.0


@pytest.mark.slow
def test_r_toggles_recording_and_h_toggles_hud(viewer, tmp_path):
    viewer.app.recorder.directory = str(tmp_path)
    assert viewer.app.update_mode == UpdateMode.REALTIME
    viewer.on_key(_Key("r"))
    assert viewer.app.update_mode == UpdateMode.RECORDING
    viewer.tick()  # writes one PNG through the async recorder
    viewer.app.recorder.flush()
    assert list(tmp_path.glob("*.png")), "recording mode must write frames"
    viewer.on_key(_Key("r"))
    assert viewer.app.update_mode == UpdateMode.REALTIME

    hud = viewer.app.show_hud
    viewer.on_key(_Key("h"))
    assert viewer.app.show_hud != hud
    viewer.on_key(_Key("h"))


def test_escape_closes(viewer):
    viewer.on_key(_Key("escape"))
    assert viewer.closed


@pytest.mark.slow
def test_r_retargets_dt(tmp_path):
    """main.rs:318-333: R retargets the adaptive dt to exact 1/60 s recording
    frames through `TimeState.target_frame_length` on the host clock (an
    np.float32, carried into the solver's step), and clears it again."""
    app = _app()
    app.recorder.directory = str(tmp_path)
    v = InteractiveViewer(app, figsize=(4, 3))
    for _ in range(20):  # tick until the governor actually runs a step
        v.tick()
        if app.time_manager.num_simulation_steps > 0:
            break
    assert app.time_manager.num_simulation_steps > 0

    v.on_key(_Key("r"))
    assert app.update_mode == UpdateMode.RECORDING
    target = app.carry.time.target_frame_length
    assert type(target) is np.float32 and target == np.float32(1.0 / 60.0)
    for _ in range(3):
        v.tick()  # recording mode forces 1/60 frame deltas: steps always run
    assert app.time_manager.num_simulation_steps > 0
    assert app.carry.time.target_frame_length == np.float32(1.0 / 60.0)

    v.on_key(_Key("r"))
    assert app.update_mode == UpdateMode.REALTIME
    assert app.carry.time.target_frame_length == 0.0
    v.tick()
