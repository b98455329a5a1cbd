"""Headless application harness: scene + frame loop + rendering + recording
(PyTorch port of yasph2d_tpu/app.py).

The reference app (reference: src/main.rs) as a headless frame producer: the same
default dam-break scene, the same solver defaults (DFSPH with XSPH viscosity, cfl
1.5; WCSPH alternative with cfl 0.2), the same TimeManager frame-loop governor, the
same camera framing, and the same recording mode (forced 1/60 s frame deltas ->
deterministic sim, PNG per frame). "Realtime" mode paces against the wall clock like
the reference's windowed mode.

The solver steps on `device` (the card by default: plain tensor operations on
the table kinds, K5 on the sorted kinds, K5 + K4 on the padded kinds, K1 + K2
on the plane kinds; `device="cpu"` runs the kernels' plain twins); the
frame is drawn on the host by the native rasterizer from the live rows read back
once per frame. Per-step processing-time history (len 80) mirrors the reference
HUD statistics (main.rs:61, 277-290).
"""

import collections
import dataclasses
import enum
import math
from typing import Optional

import numpy as np
import torch

from .config import KINDS, build_solver, require_device, require_kind, solver_boundary
from .models.viscosity import XSPHViscosityModel
from .render.camera import Camera
from .render.renderer import ParticleRenderer, Recorder
from .timemanager import (
    AdaptiveTimeStep,
    SimulationStepResult,
    TimeManager,
    TimerConfig,
)
from .utils.profiling import StepTimer
from .world import FluidParticleWorld

RECORDING_FPS = 60.0  # main.rs:62
SIMULATION_STEP_HISTORY_LENGTH = 80  # main.rs:61
# the adaptive CFL factor of each solver kind (main.rs:115-118; the JAX app's table)
CFL_FACTOR = {"wcsph": 0.2, "wcsph_dense": 0.2, "wcsph_padded": 0.2,
              "wcsph_plane": 0.2, "dfsph": 1.5, "dfsph_dense": 1.5,
              "dfsph_padded": 1.5, "dfsph_plane": 1.5}


class UpdateMode(enum.Enum):
    REALTIME = enum.auto()
    RECORDING = enum.auto()


def reset_fluid(world: FluidParticleWorld):
    """The reference's default scene (main.rs:177-196): dam-break into a tank with a
    ramp, closed container."""
    world.remove_all_fluid_particles()
    world.remove_all_boundary_particles()

    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 2.5), (2.0, 2.5), 4)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 4)
    world.add_boundary_thick_line((0.0, 0.0), (0.0, 2.5), 4)
    world.add_boundary_thick_line((2.0, 0.0), (2.0, 2.5), 4)

    world.add_boundary_thick_line((0.0, 0.6), (1.75, 0.5), 2)

    # close off the container - stop gap for endlessly falling particles (main.rs:189-192)
    world.add_boundary_thick_line((0.0, 2.5), (2.0, 2.5), 2)
    world.add_boundary_thick_line((-2.0, -0.5), (4.0, -0.5), 4)


def default_world(particle_density: float = 10000.0) -> FluidParticleWorld:
    """Reference fluid constants (main.rs:85-89): smoothing factor 2, 10000
    particles/m^2, rho0 = 100 kg/m^2."""
    world = FluidParticleWorld(2.0, particle_density, 100.0)
    reset_fluid(world)
    return world


def _stamp_hud(image: np.ndarray, text: str) -> np.ndarray:
    """Draw the HUD text block into the frame (PIL; no-op if PIL is missing)."""
    try:
        from PIL import Image, ImageDraw
    except ImportError:  # pragma: no cover
        return image
    img = Image.fromarray(image)
    draw = ImageDraw.Draw(img)
    draw.multiline_text((8, 8), text, fill=(255, 255, 255))
    return np.asarray(img)


class SimulationApp:
    """Headless MainState (reference: main.rs:45-59, 301-401).

    `solver` is one of the solver kinds (config.KINDS), each with the JAX
    app's solver class and grid: `dfsph` (the default, the reference's:
    main.rs:91) and `wcsph` on the world's GridConfig and `boundary_grid`,
    `dfsph_dense` / `wcsph_dense` and `dfsph_padded` / `wcsph_padded` on
    `world.dense_grid(occupancy=8)` (the K5 route), `dfsph_plane` /
    `wcsph_plane` on the same grid with `use_pallas_slotmajor=True` (K1 + K2).
    An unknown kind raises; `device="cuda"` without a card raises.
    """

    def __init__(
        self,
        solver: str = "dfsph",  # reference default (main.rs:91)
        world: Optional[FluidParticleWorld] = None,
        resolution=(1920, 1080),
        update_mode: UpdateMode = UpdateMode.REALTIME,
        recording_dir: str = "recording",
        device="cuda",
    ):
        require_kind(solver)
        self.device = require_device(device, "SimulationApp")
        self.world = world if world is not None else default_world()
        h = self.world.properties.smoothing_length

        step_config = AdaptiveTimeStep(
            timestep_max=1.0 / 120.0 / 3.0,  # main.rs:122
            timestep_min=1.0 / 60.0 / 400.0,  # main.rs:123
            cfl_factor=CFL_FACTOR[solver],
            target_frame_length=(
                1.0 / RECORDING_FPS if update_mode == UpdateMode.RECORDING else None
            ),
        )
        dense_grid = self.world.dense_grid(occupancy=8)
        if KINDS[solver][1] == "plane":
            dense_grid = dataclasses.replace(dense_grid, use_pallas_slotmajor=True)
        self.solver = build_solver(
            solver, self.world,
            viscosity_model=XSPHViscosityModel(smoothing_length=h),  # main.rs:93
            properties=self.world.properties,
            grid=dense_grid,
            step_config=step_config,
        )
        self.solver_name = solver

        self.time_manager = TimeManager(
            TimerConfig(
                step_config=step_config,
                max_simulated_time_per_frame=1.0 / 30.0,  # main.rs:128
            )
        )
        self.update_mode = update_mode

        self.camera = Camera.center_around_world_rect(
            (0.0, 0.0, float(resolution[0]), float(resolution[1])),
            (-0.1, -0.1, 2.1, 1.6),  # main.rs:141
        )
        self.renderer = ParticleRenderer(
            camera=self.camera,
            particle_radius=self.world.properties.particle_radius,
            resolution=resolution,
        )
        self.recorder = Recorder(recording_dir)

        self.step_timer = StepTimer(SIMULATION_STEP_HISTORY_LENGTH)
        self.step_duration_history = self.step_timer.history
        self.warnings = collections.deque(maxlen=100)
        self.show_hud = False
        self.simulation_processing_time_total = 0.0
        self.simulation_is_realtime = True
        self.last_diagnostics = None

        self.boundary = solver_boundary(solver, self.world, self.solver, self.device)
        # boundary positions for rendering, independent of the solver's index space
        self._boundary_render_positions = self.world.host_boundary_positions()
        self._init_carry()

    def _init_carry(self):
        state = self.world.initial_state(device=self.device)
        self.carry = self.solver.init_carry(state, self.boundary)
        self.carry = self.carry._replace(time=self.time_manager.time_state)

    def reset_simulation(self):
        """reference: main.rs:292-298."""
        self.time_manager.restart()
        self.simulation_processing_time_total = 0.0
        self._init_carry()

    def set_update_mode(self, mode: UpdateMode, reset: bool = True):
        """R-key toggle (main.rs:310-331): switch realtime <-> recording,
        retarget the adaptive dt to exact 1/60 s frame boundaries while
        recording (TimeState.target_frame_length on the host clock), and reset
        the simulation like the reference does.

        Documented divergence (as in the JAX package): main.rs's R-key match
        arms assign the target to the OPPOSITE branch of their own comments
        (the recording branch sets AdaptiveTimeStepTarget::None, the realtime
        branch sets TargetFrameLength, main.rs:312-329); this implements the
        commented intent ("When doing recording, we want to hit the exact
        frame times"), not the swap."""
        if mode == self.update_mode:
            return
        self.update_mode = mode
        if reset:
            self.reset_simulation()
        target = 1.0 / RECORDING_FPS if mode == UpdateMode.RECORDING else None
        self.time_manager.time_state = (
            self.time_manager.time_state.with_target_frame_length(target)
        )
        self.carry = self.carry._replace(time=self.time_manager.time_state)

    # -------------------------------------------------------------- frame loop

    def single_sim_step(self):
        """reference: main.rs:277-290 (with step-duration history)."""
        with self.step_timer:
            self.carry = self.carry._replace(time=self.time_manager.time_state)
            self.carry, self.last_diagnostics = self.solver.step(self.carry, self.boundary)
            self.time_manager.time_state = self.carry.time
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.simulation_processing_time_total += self.step_timer.last
        self._check_solver_health()

    def _check_solver_health(self):
        """Solver warnings the reference prints per step (dfsph.rs:236-245, 391-400;
        neighborhood_search.rs:361): iteration caps hit, neighbor overflow, non-finite
        residuals."""
        d = self.last_diagnostics
        if d is None:
            return
        drops = int(d.neighbor_drops)
        if drops:
            self.warnings.append(f"neighbor overflow: {drops} dropped")
        if hasattr(self.solver, "max_density_iterations"):
            if int(d.density_iterations) > self.solver.max_density_iterations:
                self.warnings.append(
                    f"density loop hit iteration cap "
                    f"(err {float(d.avg_density_error):.4g})"
                )
            if int(d.divergence_iterations) > self.solver.max_divergence_iterations:
                self.warnings.append(
                    f"divergence loop hit iteration cap "
                    f"(err {float(d.avg_divergence):.4g})"
                )
        if not (math.isfinite(float(d.avg_density_error))
                and math.isfinite(float(d.avg_divergence))):
            self.warnings.append("non-finite solver residual")

    def update(self):
        """One frame's worth of simulation steps (reference: main.rs:339-364)."""
        if self.update_mode == UpdateMode.RECORDING:
            self.time_manager.force_frame_delta(1.0 / RECORDING_FPS)
        while True:
            result = self.time_manager.simulation_frame_loop()
            if result == SimulationStepResult.PERFORM_STEP_AND_CALL_AGAIN:
                self.single_sim_step()
            elif result == SimulationStepResult.CAUGHT_UP_WITH_RENDER_TIME:
                self.simulation_is_realtime = True
                break
            else:  # DROPPING_SIMULATION_STEPS
                self.simulation_is_realtime = False
                break

    def hud_text(self) -> str:
        """The reference HUD (main.rs:198-237): frame processing time, steps per
        frame, average step time over the history window, last dt, total simulated
        vs processed time, and the REALTIME OFF banner."""
        tm = self.time_manager
        avg_step_ms = (
            1e3 * sum(self.step_duration_history) / len(self.step_duration_history)
            if self.step_duration_history else 0.0
        )
        lines = [
            f"frame: {tm.duration_last_frame * 1e3:.2f}ms",
            f"steps/frame: {tm.num_simulation_steps_this_frame}",
            f"avg step: {avg_step_ms:.2f}ms (n={len(self.step_duration_history)})",
            f"dt: {tm.simulation_step * 1e3:.3f}ms",
            f"simulated: {tm.total_simulated_time:.3f}s "
            f"(processing {self.simulation_processing_time_total:.2f}s)",
        ]
        if not self.simulation_is_realtime:
            lines.append("REALTIME OFF")
        if self.warnings:
            lines.append(f"! {self.warnings[-1]}")
        return "\n".join(lines)

    def particle_state(self):
        """Live particle (positions, velocities) as host NumPy arrays, read from
        the solver's exported state (the particles, or the slots)."""
        particles = self.solver.export_state(self.carry)
        alive = particles.alive
        return (
            particles.positions[alive].cpu().numpy(),
            particles.velocities[alive].cpu().numpy(),
        )

    def draw(self) -> np.ndarray:
        """Read back particle state and rasterize one frame
        (reference: main.rs:366-400)."""
        positions, velocities = self.particle_state()
        image = self.renderer.render(
            positions=positions,
            velocities=velocities,
            boundary_positions=self._boundary_render_positions,
        )
        if self.show_hud:
            image = _stamp_hud(image, self.hud_text())
        if self.update_mode == UpdateMode.RECORDING:
            self.recorder.save_frame(self.time_manager.num_frames_rendered, image)
        self.time_manager.on_frame_presented(1.0)
        return image

    def run(self, num_frames: int):
        """Produce num_frames frames (the reference's event loop, headless)."""
        frames = []
        for _ in range(num_frames):
            self.update()
            frames.append(self.draw())
        self.recorder.flush()  # async PNG writes complete before returning
        return frames
