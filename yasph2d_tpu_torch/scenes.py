"""Benchmark scenes (copies of the scene functions in the repository's bench.py,
which imports JAX)."""

from .world import FluidParticleWorld


def double_dam_break(target_particles: int) -> FluidParticleWorld:
    """Two fluid columns in a 4m x 2.5m tank with a box obstacle between them."""
    # Two rects of 0.8 x 1.2 m^2; derated lattice density 0.81 * d fills ~target.
    area = 2 * 0.8 * 1.2
    particle_density = target_particles / (area * 0.81)
    world = FluidParticleWorld(2.0, particle_density, 100.0)

    world.add_fluid_rect((0.1, 0.05, 0.8, 1.2), 0.05)
    world.add_fluid_rect((3.1, 0.05, 0.8, 1.2), 0.05)

    # tank (thick lines extend to the LEFT of start->end; order walls to grow outward)
    world.add_boundary_thick_line((0.0, 0.0), (4.0, 0.0), 3)
    world.add_boundary_thick_line((0.0, 2.5), (0.0, 0.0), 3)
    world.add_boundary_thick_line((4.0, 0.0), (4.0, 2.5), 3)
    world.add_boundary_thick_line((4.0, 2.5), (0.0, 2.5), 3)
    # box obstacle between the columns
    world.add_boundary_thick_line((1.7, 0.0), (1.7, 0.45), 2)
    world.add_boundary_thick_line((1.7, 0.45), (2.3, 0.45), 2)
    world.add_boundary_thick_line((2.3, 0.45), (2.3, 0.0), 2)
    return world
