"""Time stepping: the per-step dt policy and the simulation clock (PyTorch port of
yasph2d_tpu/timemanager.py; reference: src/sph/timemanager.rs).

The port keeps the clock on the host: the DFSPH step already reads one residual
per pressure-loop iteration back from the device, so dt lives as a host float32
scalar and reaches the kernels as a C float. All arithmetic below is explicit
np.float32, the same f32 operations the JAX package traces, so the adaptive dt
is bit-identical to it for the same max velocity. The host frame-loop
`TimeManager` is not ported yet.

Contracts kept from the reference:
- CFL dt = cfl_factor * 0.4 * particle_diameter / (max_velocity + 1e-5)
  (timemanager.rs:264);
- upper bound min(timestep_max, 2 * previous_dt) (timemanager.rs:265-267);
- a step's dt is accounted *before* the step runs (timemanager.rs:246-248);
- TargetFrameLength clamps the lower bound with the time elapsed since the
  last target, as written in the reference (timemanager.rs:268-274).
"""

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
    new_dt = np.maximum(lower_bound, np.minimum(upper_bound, time_cfl))
    return time_state._replace(dt=f32(new_dt))
