"""Interactive realtime viewer: live window + keyboard input (PyTorch port of
yasph2d_tpu/viewer.py).

Closes the reference app's interactive surface (reference: src/main.rs:29,
301-401 — a ggez/winit window with per-frame redraw and key handling) with a
matplotlib window driven by a frame timer:

- live scatter of fluid particles, colored by the reference's velocity heatmap
  (|v| * 0.1, main.rs:74-81, 255), boundary particles in grey;
- the reference's keys (main.rs:302-337):
    Esc    quit
    Space  reset the simulation (MainState::reset_simulation, main.rs:292-298)
    R      toggle PNG recording mode (forces 1/60 s frame deltas; frames land in
           the recording directory via the async Recorder)
    H      toggle the HUD overlay (frame ms, steps/frame, dt, REALTIME banner)
- frame pacing through the same TimeManager frame-loop governor as the headless
  app (SimulationApp.update), so realtime vs recording semantics match main.rs.

The R key retargets the ADAPTIVE dt to exact 1/60 s frame boundaries
(AdaptiveTimeStepTarget::TargetFrameLength semantics, main.rs:318-333) through
`TimeState.target_frame_length` on the host clock (see
SimulationApp.set_update_mode, including the documented divergence from
main.rs's swapped match arms). The solver steps on the app's device.

Headless environments: matplotlib's Agg backend has no window or key events, but
the viewer still constructs and ticks (tests/test_torch_viewer.py drives it that
way); on a desktop (TkAgg/QtAgg) `InteractiveViewer(app).run()` opens the live
window. matplotlib is imported only when a viewer is made.
"""

import numpy as np

from .app import RECORDING_FPS, SimulationApp, UpdateMode
from .render.renderer import heatmap_color


class InteractiveViewer:
    """Live window around a SimulationApp (reference: MainState + ggez event loop)."""

    def __init__(self, app: SimulationApp, figsize=(9.6, 5.4), fps: float = 60.0):
        import matplotlib.pyplot as plt

        self.app = app
        self.fps = fps
        self.closed = False

        self.fig, self.ax = plt.subplots(figsize=figsize)
        self.fig.canvas.manager.set_window_title(
            "yasph2d_tpu_torch"
        ) if getattr(self.fig.canvas, "manager", None) else None
        cam = app.camera
        # same world rect the reference frames (main.rs:141 via Camera)
        half_w = cam.screen[2] / (2.0 * cam.pixel_per_world_unit)
        half_h = abs(cam.screen[3]) / (2.0 * cam.pixel_per_world_unit)
        self.ax.set_xlim(cam.position[0] - half_w, cam.position[0] + half_w)
        self.ax.set_ylim(cam.position[1] - half_h, cam.position[1] + half_h)
        self.ax.set_aspect("equal")
        self.ax.set_facecolor("black")

        r_world = app.world.properties.particle_radius
        # scatter sizes are in points^2; approximate world->points via axis size
        px_per_world = cam.pixel_per_world_unit * 72.0 / self.fig.dpi
        size = max((2.0 * r_world * px_per_world) ** 2, 1.0)

        b = app._boundary_render_positions
        self.ax.scatter(b[:, 0], b[:, 1], s=size, c="0.4", linewidths=0)
        self.scatter = self.ax.scatter([], [], s=size, linewidths=0)
        self.hud = self.ax.text(
            0.02, 0.98, "", transform=self.ax.transAxes, va="top",
            color="white", family="monospace", fontsize=8,
        )

        self.fig.canvas.mpl_connect("key_press_event", self.on_key)
        self.fig.canvas.mpl_connect("close_event", self._on_close)

    # ------------------------------------------------------------------ events

    def _on_close(self, _event=None):
        self.closed = True

    def on_key(self, event):
        """Esc / Space / R / H (reference: main.rs:302-337)."""
        import matplotlib.pyplot as plt

        if event.key == "escape":
            self.closed = True
            plt.close(self.fig)
        elif event.key == " ":
            self.app.reset_simulation()
        elif event.key in ("r", "R"):
            # retargets the adaptive dt to exact 1/60 s recording frames
            # (main.rs:310-331 semantics)
            self.app.set_update_mode(
                UpdateMode.REALTIME
                if self.app.update_mode == UpdateMode.RECORDING
                else UpdateMode.RECORDING
            )
        elif event.key in ("h", "H"):
            self.app.show_hud = not self.app.show_hud

    # ------------------------------------------------------------------- frame

    def tick(self):
        """One frame: pump the simulation frame loop, redraw the scatter."""
        app = self.app
        app.update()
        pos, vel = app.particle_state()  # alive-filtered, any carry layout
        speed = np.sqrt((vel * vel).sum(-1))
        self.scatter.set_offsets(pos)
        self.scatter.set_color(heatmap_color(speed * 0.1))  # main.rs:255
        self.hud.set_text(app.hud_text() if app.show_hud else "")
        if app.update_mode == UpdateMode.RECORDING:
            app.recorder.save_frame(
                app.time_manager.num_frames_rendered, self._grab_frame()
            )
        app.time_manager.on_frame_presented(1.0)

    def _grab_frame(self) -> np.ndarray:
        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())
        return buf[..., :3].copy()

    def run(self, max_frames=None):
        """Open the window and run until Esc/close (or max_frames for tests)."""
        import matplotlib.pyplot as plt

        plt.ion()
        plt.show(block=False)
        n = 0
        while not self.closed and (max_frames is None or n < max_frames):
            self.tick()
            self.fig.canvas.draw_idle()
            self.fig.canvas.flush_events()
            plt.pause(max(1.0 / self.fps, 1e-3))
            n += 1
        self.app.recorder.flush()


def main(argv=None):
    """`python -m yasph2d_tpu_torch.viewer [solver] [particle_density] [device]`"""
    import sys

    argv = argv if argv is not None else sys.argv[1:]
    solver = argv[0] if argv else "dfsph_dense"
    density = float(argv[1]) if len(argv) > 1 else 2500.0
    device = argv[2] if len(argv) > 2 else "cuda"
    from .app import default_world

    app = SimulationApp(solver=solver, world=default_world(density), device=device)
    InteractiveViewer(app).run()


if __name__ == "__main__":
    main()
