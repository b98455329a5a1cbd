"""Time stepping: the per-step dt policy, the simulation clock and the frame-loop
governor (PyTorch port of yasph2d_tpu/timemanager.py; reference:
src/sph/timemanager.rs).

The port keeps the clock on the host: the DFSPH step already reads one residual
per pressure-loop iteration back from the device, so dt lives as a host float32
scalar and reaches the kernels as a C float. All arithmetic below is explicit
np.float32, the same f32 operations the JAX package traces, so the adaptive dt
is bit-identical to it for the same max velocity. `TimeManager` is the
reference's three-clock bookkeeping (wall / render / simulation,
timemanager.rs:61-71) with its frame-loop governor and the 90% lag acceptance
(timemanager.rs:13-19, 231-242); it drives the app and the recorder, and reads
no device value.

Contracts kept from the reference:
- CFL dt = cfl_factor * 0.4 * particle_diameter / (max_velocity + 1e-5)
  (timemanager.rs:264);
- upper bound min(timestep_max, 2 * previous_dt) (timemanager.rs:265-267);
- a step's dt is accounted *before* the step runs (timemanager.rs:246-248);
- TargetFrameLength clamps the lower bound with the time elapsed since the
  last target, as written in the reference (timemanager.rs:268-274).

`CLAMPS` counts, on the host, which bound set each adaptive step's dt: a dt
that sits on `timestep_min` for long says that the floor, not the CFL
condition, paces the flow.
"""

import collections
import enum
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import numpy as np

from .units import REAL_NP

f32 = REAL_NP


@dataclass(frozen=True)
class FixedTimeStep:
    """SimulationStepConfig::FixedTimeStep (timemanager.rs:40)."""

    timestep: float


@dataclass(frozen=True)
class AdaptiveTimeStep:
    """SimulationStepConfig::AdaptiveTimeStep (timemanager.rs:44-59); a float
    target_frame_length enables the recording TargetFrameLength mode."""

    timestep_max: float
    timestep_min: float
    cfl_factor: float
    target_frame_length: Optional[float] = None


StepConfig = Union[FixedTimeStep, AdaptiveTimeStep]

# adaptive steps by the bound that set their dt, since the process started
# or `CLAMPS.clear()`: "floor" (timestep_min, or the frame target's lower
# bound, raised dt above the CFL dt), "ceiling" (timestep_max or twice the
# previous dt cut it), "cfl" (the CFL dt itself; also a NaN one)
CLAMPS = collections.Counter()


@dataclass(frozen=True)
class TimerConfig:
    """reference: TimerConfig (timemanager.rs:10-21)."""

    step_config: StepConfig
    max_simulated_time_per_frame: float


class TimeState(NamedTuple):
    """Simulation clock: float32 / int32 host scalars."""

    dt: np.float32  # current step length
    total_simulated_time: np.float32
    num_steps: np.int32
    target_frame_length: np.float32  # 0 = AdaptiveTimeStepTarget::None

    @classmethod
    def initial(cls, config: StepConfig) -> "TimeState":
        if isinstance(config, FixedTimeStep):
            dt0, target0 = config.timestep, 0.0
        else:  # timemanager.rs:106-109
            dt0 = config.timestep_min
            target0 = config.target_frame_length or 0.0
        return cls(f32(dt0), f32(0.0), np.int32(0), f32(target0))

    def with_target_frame_length(self, target: Optional[float]) -> "TimeState":
        """Set or clear the recording frame target (the R key, main.rs:318-333)."""
        return self._replace(target_frame_length=f32(target or 0.0))

    def account_step(self) -> "TimeState":
        """Advance the clock for the step about to run: total time moves by the
        *current* dt (timemanager.rs:246-248)."""
        return self._replace(
            total_simulated_time=f32(self.total_simulated_time + self.dt),
            num_steps=np.int32(self.num_steps + 1),
        )


def update_simulation_step(config: StepConfig, time_state: TimeState,
                           particle_diameter: float, max_velocity) -> TimeState:
    """dt policy evaluated mid-step by the solver (timemanager.rs:252-279);
    `time_state` must already be advanced by `account_step`."""
    if isinstance(config, FixedTimeStep):
        return time_state._replace(dt=f32(config.timestep))

    time_cfl = f32(config.cfl_factor * 0.4 * particle_diameter) / (
        f32(max_velocity) + f32(1e-5)
    )
    upper_bound = np.minimum(f32(config.timestep_max), f32(time_state.dt * f32(2.0)))
    lower_bound = f32(config.timestep_min)
    target = time_state.target_frame_length
    if target > 0:
        total = time_state.total_simulated_time
        time_to_target = f32(total - target * np.floor(f32(total / target)))
        lower_bound = np.minimum(lower_bound, time_to_target)
    # np.minimum/np.maximum propagate NaN like jnp's (Python min/max would not)
    capped = np.minimum(upper_bound, time_cfl)
    new_dt = np.maximum(lower_bound, capped)
    CLAMPS["floor" if lower_bound > capped else "ceiling" if upper_bound < time_cfl
           else "cfl"] += 1
    return time_state._replace(dt=f32(new_dt))


class SimulationStepResult(enum.Enum):
    """reference: timemanager.rs:95-101."""

    PERFORM_STEP_AND_CALL_AGAIN = enum.auto()
    CAUGHT_UP_WITH_RENDER_TIME = enum.auto()
    DROPPING_SIMULATION_STEPS = enum.auto()


FRAME_DURATION_HISTORY_LENGTH = 50  # timemanager.rs:103


class TimeManager:
    """Host frame-loop governor over the simulation clock `time_state`.

    Owns the wall-clock and render-time bookkeeping; the caller's solver step
    advances `time_state.dt` and hands the clock back after each step."""

    def __init__(self, config: TimerConfig):
        self.config = config
        self.restart()

    def restart(self):
        """reference: timemanager.rs:131-133."""
        self.time_state = TimeState.initial(self.config.step_config)
        self.timestamp_last_frame = time.perf_counter()
        self.duration_last_frame = 0.0
        self.frame_duration_history = collections.deque(
            maxlen=FRAME_DURATION_HISTORY_LENGTH
        )
        self.total_rendered_time = 0.0
        self.current_frame_delta = 0.0
        self.num_frames_rendered = 0
        self.num_simulation_steps_this_frame = 0
        self.simulated_time_this_frame = 0.0
        self.accepted_simulation_to_render_lag = 0.0

    # -------------------------------------------------------------- accessors

    @property
    def simulation_step(self) -> float:
        return float(self.time_state.dt)

    @property
    def total_simulated_time(self) -> float:
        return float(self.time_state.total_simulated_time)

    @property
    def num_simulation_steps(self) -> int:
        return int(self.time_state.num_steps)

    def frame_delta(self) -> float:
        return self.current_frame_delta

    # ------------------------------------------------------------- frame loop

    def force_frame_delta(self, delta: float):
        """Jump the render clock (recording / fast-forward, timemanager.rs:186-190)."""
        self.total_rendered_time -= self.current_frame_delta
        self.current_frame_delta = delta
        self.total_rendered_time += self.current_frame_delta

    def on_frame_presented(self, wallclock_to_rendertime_scale: float = 1.0):
        """reference: timemanager.rs:193-206."""
        now = time.perf_counter()
        self.duration_last_frame = now - self.timestamp_last_frame
        self.frame_duration_history.append(self.duration_last_frame)
        self.current_frame_delta = (
            self.duration_last_frame * wallclock_to_rendertime_scale
        )
        self.total_rendered_time += self.current_frame_delta
        self.timestamp_last_frame = now
        self.num_simulation_steps_this_frame = 0
        self.simulated_time_this_frame = 0.0
        self.num_frames_rendered += 1

    def skip_simulation_frame(self):
        """reference: timemanager.rs:208-210."""
        self.accepted_simulation_to_render_lag += self.current_frame_delta

    def simulation_frame_loop(self) -> SimulationStepResult:
        """One governor decision (reference: timemanager.rs:212-249). When it returns
        PERFORM_STEP_AND_CALL_AGAIN the caller must run exactly one solver step with
        the current TimeState (already advanced here)."""
        predicted_rendered_time = self.total_rendered_time + self.current_frame_delta
        residual_time = max(
            predicted_rendered_time
            - (self.total_simulated_time + self.accepted_simulation_to_render_lag),
            0.0,
        )
        if residual_time < self.simulation_step:
            return SimulationStepResult.CAUGHT_UP_WITH_RENDER_TIME

        if self.simulated_time_this_frame > self.config.max_simulated_time_per_frame:
            # Accept 90% of the lag instead of dropping all lost frames: avoids
            # oscillating between realtime and offline (timemanager.rs:231-242).
            self.accepted_simulation_to_render_lag += residual_time * 0.9
            return SimulationStepResult.DROPPING_SIMULATION_STEPS

        self.num_simulation_steps_this_frame += 1
        self.simulated_time_this_frame += self.simulation_step
        self.time_state = self.time_state.account_step()
        return SimulationStepResult.PERFORM_STEP_AND_CALL_AGAIN
