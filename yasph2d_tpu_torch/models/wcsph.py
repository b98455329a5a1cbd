"""WCSPH on neighbour tables (PyTorch port of yasph2d_tpu/models/wcsph.py;
Becker & Teschner 2007, reference: src/sph/solver/wscsph.rs).

Tait EOS (gamma 7), leapfrog, symmetric pressure forces with the Spiky kernel,
Poly6 density, XSPH or physical viscosity, Monaghan-Kajtar boundary penalty.
`WCSPHSolver` is the table layout: each step re-sorts the particles by cell
key and rebuilds their (N, K) neighbour tables (world.update_neighborhood),
then runs its pair passes as gathers through the tables and masked sums, in
plain tensor operations (the JAX package runs this layout in plain XLA, no
Pallas kernel). The step is the JAX step's, in its operation order:

- wscsph.rs:141-151 leapfrog part 1               -> before the re-sort
- wscsph.rs:153-154 neighbourhood and densities   -> update_neighborhood,
                                                     update_densities
- wscsph.rs:59-118 accelerations                  -> `_accelerations`
- wscsph.rs:158-167 CFL with the old-dt estimate  -> on the host clock
- wscsph.rs:169-178 leapfrog part 2, the new dt   -> the same quirk

The sums over K are torch's, so a step agrees with the JAX step to f32
rounding. The slot-layout solvers are in models/wcsph_dense.py (sorted and
padded carries) and models/wcsph_plane.py (plane carry).
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops import pair
from ..ops.dense_grid import f32_scalar
from ..ops.neighborhood import CellGrid, GridConfig
from ..ops.smoothing_kernels import Poly6, Spiky
from ..timemanager import StepConfig, TimeState, update_simulation_step
from ..units import REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import (
    GRAVITY,
    FluidProperties,
    ParticleState,
    update_densities,
    update_neighborhood,
)
from .dfsph_dense import DFSPHSlotSolver
from .viscosity import ViscosityModel

f32 = REAL_NP

# gamma hardcoded to 7 as proposed in the paper (reference: wscsph.rs:26)
TAIT_EQUATION_GAMMA = 7


def compute_stiffness(
    properties: FluidProperties,
    target_density_variation: float = 0.01,
    expected_max_flow_speed: float = 1.0,
) -> float:
    """B = rho0 * c^2 / gamma with c = v_max / sqrt(eta), a Python double
    (reference: set_compressibility, wscsph.rs:45-49; defaults from wscsph.rs:39)."""
    speed_of_sound = expected_max_flow_speed / (target_density_variation**0.5)
    return properties.fluid_density * speed_of_sound**2 / TAIT_EQUATION_GAMMA


def tait_pressure(stiffness, fluid_density, local_density: torch.Tensor):
    """Tait EOS with pressure clamp for particle deficiency
    (reference: wscsph.rs:52-57), in the JAX package's f32 operations: the
    ratio divides by a tensor (a Python divisor becomes a reciprocal multiply
    on CUDA) and ratio**7 is XLA's integer_pow expansion."""
    rho0 = torch.tensor(fluid_density, dtype=REAL, device=local_density.device)
    ratio = torch.clamp(local_density / rho0, min=1.0)
    r2 = ratio * ratio
    r3 = ratio * r2
    r4 = r2 * r2
    return float(stiffness) * (r3 * r4 - 1.0)


class WCSPHCarry(NamedTuple):
    """Step-to-step state: the particles (sorted by cell key), the accelerations
    the leapfrog carries across steps (wscsph.rs:21-22), the clock."""

    particles: ParticleState
    accelerations: torch.Tensor  # (N, 2), in the particles' order
    time: TimeState


@dataclass(frozen=True)
class WCSPHSolver:
    """WCSPH on neighbour tables (`grid` is the world's GridConfig, the
    boundary its `boundary_grid()`); defaults as wscsph.rs:35-39."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: GridConfig
    step_config: StepConfig
    boundary_force_factor: float = 1.0
    target_density_variation: float = 0.01
    expected_max_flow_speed: float = 1.0
    gravity: tuple = GRAVITY

    def __post_init__(self):
        h = self.properties.smoothing_length
        object.__setattr__(self, "density_kernel", Poly6(h))
        object.__setattr__(self, "pressure_kernel", Spiky(h))
        object.__setattr__(self, "stiffness", compute_stiffness(
            self.properties, self.target_density_variation,
            self.expected_max_flow_speed,
        ))

    def init_carry(self, state: ParticleState, boundary=None) -> WCSPHCarry:
        """Zero accelerations (clear_cached_data, wscsph.rs:122-124). `boundary`
        is accepted so that every solver's init_carry takes the same
        arguments, and ignored."""
        return WCSPHCarry(particles=state,
                          accelerations=torch.zeros_like(state.velocities),
                          time=TimeState.initial(self.step_config))

    def export_state(self, carry: WCSPHCarry) -> ParticleState:
        """The particles, N rows in cell order (`alive` marks the real ones)."""
        return carry.particles

    def _accelerations(self, positions, velocities, densities, pressures,
                       neighborhood, boundary_positions, dt):
        """Pressure + viscosity over the fluid table, the radial boundary force
        over the boundary table, gravity (wscsph.rs:59-118)."""
        mass = self.properties.particle_mass
        dyn, stat = neighborhood.dynamic, neighborhood.static

        rho_j = pair.gather(densities, dyn.idx)
        ri_to_rj, r_sq, r = pair.pair_geometry(positions, pair.gather(positions, dyn.idx))
        # symmetric forces -m (p_i + p_j) / (2 rho_i rho_j) (wscsph.rs:66-69, 100-101)
        coef = (f32_scalar(-mass) * (pressures[:, None] + pair.gather(pressures, dyn.idx))
                / (2.0 * densities[:, None] * rho_j))
        accel_pairs = coef[..., None] * self.pressure_kernel.gradient(ri_to_rj, r_sq, r)
        accel_pairs = accel_pairs + self.viscosity_model.compute_viscous_acceleration(
            float(dt), r_sq, r, mass, rho_j,
            pair.gather(velocities, dyn.idx) - velocities[:, None, :])
        accel = pair.masked_sum(accel_pairs, dyn.mask)

        # Monaghan-Kajtar: a -= f W(r) / r^2 ri_to_rj (wscsph.rs:108-116)
        b_to_j, b_r_sq, b_r = pair.pair_geometry(
            positions, pair.gather(boundary_positions, stat.idx))
        w = self.pressure_kernel.evaluate(b_r_sq, b_r)
        radial = (f32_scalar(-self.boundary_force_factor) * w / b_r_sq)[..., None] * b_to_j
        accel = accel + pair.masked_sum(radial, stat.mask)
        gvec = torch.tensor(self.gravity, dtype=REAL, device=positions.device)
        return accel + gvec[None, :]

    def step(self, carry: WCSPHCarry, boundary: CellGrid):
        """One simulation step (reference: wscsph.rs:126-179); `carry.time`
        must already be accounted (`account_step`). Returns (carry,
        Diagnostics)."""
        particles, accel, time_state = carry
        dt = time_state.dt

        # leapfrog part 1: v at t + 1/2, positions at t + 1 (wscsph.rs:141-151)
        velocities = particles.velocities + float(f32(0.5) * dt) * accel
        positions = particles.positions + velocities * float(dt)

        # the rebuild re-sorts all attributes (wscsph.rs:153); the accelerations
        # are recomputed below and need no co-sort
        (velocities, alive), positions, neighborhood = update_neighborhood(
            (velocities, particles.alive), positions, boundary, self.grid)
        densities = update_densities(positions, neighborhood, boundary.positions,
                                     self.density_kernel, self.properties.particle_mass,
                                     self.properties.fluid_density)
        pressures = tait_pressure(self.stiffness, self.properties.fluid_density, densities)
        accel = self._accelerations(positions, velocities, densities, pressures,
                                    neighborhood, boundary.positions, dt)
        # dead (padding) particles are frozen: no gravity, no advection
        accel = torch.where(alive[:, None], accel, 0.0)

        # CFL with the old-dt estimate (wscsph.rs:158-167), live particles only
        v_estimate = velocities + accel * float(dt)
        v_est_sq = torch.where(alive, (v_estimate * v_estimate).sum(dim=-1), 0.0)
        max_velocity = f32(float(torch.sqrt(v_est_sq.max())))
        time_state = update_simulation_step(
            self.step_config, time_state, self.properties.particle_radius * 2.0,
            max_velocity)

        # leapfrog part 2 with the NEW dt (the quirk of wscsph.rs:169-178)
        velocities = velocities + float(f32(0.5) * time_state.dt) * accel

        new_carry = WCSPHCarry(
            particles=ParticleState(positions, velocities, densities, alive),
            accelerations=accel,
            time=time_state,
        )
        return new_carry, Diagnostics.zeros()._replace(
            dt=dt, max_velocity=max_velocity,
            neighbor_drops=int(neighborhood.dynamic.num_dropped
                               + neighborhood.static.num_dropped))

    # the host loop of the slot solvers: account each step's dt, then step;
    # the Diagnostics aggregate all steps
    simulate = DFSPHSlotSolver.simulate
