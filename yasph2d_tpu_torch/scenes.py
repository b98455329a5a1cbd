"""Benchmark scenes (copies of the scene functions in the repository's bench.py,
which imports JAX) and the bench's solver configurations on them."""

from typing import NamedTuple

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


def reference_particle_density(target_particles: int) -> float:
    """The particle density (per m^2) that fills the reference dam-break's
    0.5 x 1.0 m^2 fluid rect with ~target particles on the derated (0.81)
    lattice (bench.py:310-324)."""
    return target_particles / (0.5 * 1.0 * 0.81)


def reference_dam_break(target_particles: int = 10_000) -> FluidParticleWorld:
    """The reference app's default dam-break scene (main.rs:177-196: fluid rect +
    tank + ramp; config.default_scene), scaled to ~target fluid particles
    (BASELINE configs 1-3)."""
    from .config import FluidConfig, SimulationConfig

    fluid = FluidConfig(particle_density=reference_particle_density(target_particles))
    return SimulationConfig(fluid=fluid).build_world()


class SolverSpec(NamedTuple):
    """One of the bench's solver configurations."""

    kind: str  # the solver kind (config.KINDS)
    slotmajor: bool  # slot kinds: pair passes on K3 (use_pallas_slotmajor) or on K5
    cfl_factor: float  # adaptive CFL factor (bench.py:116-120)
    pair_dtype: str = "float32"  # DenseGridConfig.pair_dtype
    # DFSPHPlaneSolver's fuse_loop_elementwise and fuse_ctx_elementwise (the
    # bench's YASPH_BENCH_FUSE_LOOPS / YASPH_BENCH_FUSE_CTX, bench.py:204-212)
    fused: bool = True


# The bench's solver configurations on one scene, by name. The bench's own
# default operand dtype is bfloat16 (bench.py:83-88); the *_bf16 entries run
# the plane solvers so (K1's bf16 operands) and the padded and sorted
# solvers' K5 route (K5's bf16 math mode); `dfsph_plane_unfused` is the plane
# step with both fuse switches off. The bench's `table` backend is
# `dfsph_table` (bench.py:228-236), its `dense` backend `dfsph_dense`
# (bench.py:214-217; K3, `*_k5` on K5); the WCSPH table and sorted solvers
# are the config's kinds of the same names.
SOLVERS = {
    "dfsph_plane": SolverSpec("dfsph_plane", True, 1.5),
    "dfsph_padded": SolverSpec("dfsph_padded", True, 1.5),
    "dfsph_padded_k5": SolverSpec("dfsph_padded", False, 1.5),
    "wcsph_padded": SolverSpec("wcsph_padded", True, 0.2),
    "wcsph_padded_k5": SolverSpec("wcsph_padded", False, 0.2),
    "wcsph_plane": SolverSpec("wcsph_plane", True, 0.2),
    "dfsph_plane_bf16": SolverSpec("dfsph_plane", True, 1.5, "bfloat16"),
    "wcsph_plane_bf16": SolverSpec("wcsph_plane", True, 0.2, "bfloat16"),
    "dfsph_plane_unfused": SolverSpec("dfsph_plane", True, 1.5, fused=False),
    "dfsph_padded_k5_bf16": SolverSpec("dfsph_padded", False, 1.5, "bfloat16"),
    "wcsph_padded_k5_bf16": SolverSpec("wcsph_padded", False, 0.2, "bfloat16"),
    "dfsph_table": SolverSpec("dfsph", False, 1.5),
    "wcsph_table": SolverSpec("wcsph", False, 0.2),
    "dfsph_dense": SolverSpec("dfsph_dense", True, 1.5),
    "dfsph_dense_k5": SolverSpec("dfsph_dense", False, 1.5),
    "wcsph_dense": SolverSpec("wcsph_dense", True, 0.2),
    "wcsph_dense_k5": SolverSpec("wcsph_dense", False, 0.2),
    "dfsph_dense_k5_bf16": SolverSpec("dfsph_dense", False, 1.5, "bfloat16"),
}


def bench_solver(kind: str, world: FluidParticleWorld, device="cuda", occupancy=7,
                 pair_dtype=None, ny_multiple=1):
    """(solver, boundary) of one of SOLVERS on `world`, as the bench builds them
    (bench.py:125-150, 228-236): occupancy 7, XSPH viscosity, the entry's
    adaptive CFL, the boundary on `device` (the table kinds on `world.grid`
    and `world.boundary_grid()`, the plane solvers' boundary in plane form).
    `pair_dtype` overrides the entry's operand dtype; `ny_multiple` rounds
    the grid's rows up to a multiple (the shard count of a sharded run)."""
    import dataclasses

    import yasph2d_tpu_torch as y
    from .config import build_solver, solver_boundary

    spec = SOLVERS[kind]
    grid = dataclasses.replace(world.dense_grid(occupancy=occupancy, ny_multiple=ny_multiple),
                               use_pallas_slotmajor=spec.slotmajor,
                               pair_dtype=pair_dtype or spec.pair_dtype)
    switches = {} if spec.fused else dict(fuse_loop_elementwise=False,
                                          fuse_ctx_elementwise=False)
    solver = build_solver(
        spec.kind, world,
        viscosity_model=y.XSPHViscosityModel(world.properties.smoothing_length),
        properties=world.properties,
        grid=grid,
        step_config=y.AdaptiveTimeStep(
            timestep_max=1.0 / 360.0, timestep_min=1.0 / 24000.0,
            cfl_factor=spec.cfl_factor,
        ),
        **switches,
    )
    return solver, solver_boundary(spec.kind, world, solver, device)
