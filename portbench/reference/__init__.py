"""The plain reference of the benchmark's solver steps.

Plain PyTorch on particle lists, written from the SPH equations of the
upstream solvers (Wumpf/yasph2d src/sph/solver/dfsph.rs, wscsph.rs, the
smoothing kernels and viscosity models) and of the time manager. It
imports nothing of the program under test and takes nothing the program
made but the state that the comparison judges: the neighbour search is a
cell-sorted particle list of its own, and densities, alpha factors,
boundary sums, forces, dt and the pressure solves are worked out here
again. `Consts` holds the constants, derived from the benchmark's scene
and configuration files.
"""

from typing import NamedTuple

import numpy as np


class Consts(NamedTuple):
    """Physical and solver constants of one cell, as Python floats."""

    h: float  # smoothing length = cell size = support radius
    particle_radius: float
    mass: float
    rho0: float
    gravity: tuple
    origin: tuple  # grid origin (x0, y0)
    nx: int
    ny: int
    occupancy: int  # slots a cell in the program's grid: K4's drop rule
    xsph_epsilon: float
    timestep_max: float
    timestep_min: float
    cfl_factor: float
    # DFSPH
    max_avg_density_error: float = 0.0
    max_density_iterations: int = 0
    max_divergence_error: float = 0.0
    max_divergence_iterations: int = 0
    # WCSPH
    stiffness: float = 0.0
    boundary_force_factor: float = 0.0


def consts_of(scene, cfg: dict) -> Consts:
    """The constants of `scene` (scene_gen.Scene) under the configuration
    file `cfg`."""
    t = cfg["timestep"]
    common = dict(
        h=scene.smoothing_length, particle_radius=scene.particle_radius,
        mass=scene.particle_mass, rho0=scene.fluid_density,
        gravity=tuple(cfg["gravity"]), origin=scene.grid.origin,
        nx=scene.grid.nx, ny=scene.grid.ny, occupancy=scene.grid.occupancy,
        xsph_epsilon=cfg["viscosity"]["xsph_epsilon"],
        timestep_max=t["timestep_max"], timestep_min=t["timestep_min"],
        cfl_factor=t["cfl_factor"])
    s = cfg["solver"]
    if cfg["method"] == "dfsph":
        return Consts(**common, **{k: s[k] for k in (
            "max_avg_density_error", "max_density_iterations", "max_divergence_error",
            "max_divergence_iterations")})
    # WCSPH stiffness B = rho0 c^2 / gamma, c = v_max / sqrt(eta), gamma 7
    # (wscsph.rs:45-49)
    c = s["expected_max_flow_speed"] / s["target_density_variation"] ** 0.5
    return Consts(**common, stiffness=scene.fluid_density * c * c / 7.0,
                  boundary_force_factor=s["boundary_force_factor"])


def next_dt(k: Consts, dt: np.float32, max_velocity: np.float32) -> np.float32:
    """The adaptive step (timemanager.rs:252-279, no frame target): CFL
    dt = cfl 0.4 (2 r) / (max |v| + 1e-5), within [timestep_min,
    min(timestep_max, 2 dt)], in float32."""
    f32 = np.float32
    cfl = f32(k.cfl_factor * 0.4 * k.particle_radius * 2.0) / (f32(max_velocity) + f32(1e-5))
    upper = min(f32(k.timestep_max), f32(dt * f32(2.0)))
    return f32(max(f32(k.timestep_min), min(upper, cfl)))
