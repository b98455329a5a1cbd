"""What the DFSPH and WCSPH padded adapters share: the program's grid,
properties, viscosity and time-step objects from a configuration file and
a scene."""

import torch


def solver_kwargs(cfg: dict, scene, pair_dtype: str) -> dict:
    """The keywords that `config.build_solver` takes for the slot kinds:
    XSPH viscosity, the fluid properties, the dense grid, the adaptive
    step and gravity."""
    import yasph2d_tpu_torch as y
    from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig
    from yasph2d_tpu_torch.world import FluidProperties

    g = scene.grid
    grid = DenseGridConfig(cell_size=g.cell_size, origin=g.origin, nx=g.nx, ny=g.ny,
                           occupancy=g.occupancy,
                           use_pallas_slotmajor=cfg["solver"]["use_pallas_slotmajor"],
                           pair_dtype=pair_dtype)
    props = FluidProperties(smoothing_factor=scene.smoothing_factor,
                              particle_density=scene.particle_density,
                              fluid_density=scene.fluid_density)
    t = cfg["timestep"]
    return dict(
        viscosity_model=y.XSPHViscosityModel(props.smoothing_length,
                                             cfg["viscosity"]["xsph_epsilon"]),
        properties=props, grid=grid,
        step_config=y.AdaptiveTimeStep(timestep_max=t["timestep_max"],
                                       timestep_min=t["timestep_min"],
                                       cfl_factor=t["cfl_factor"]),
        gravity=tuple(cfg["gravity"]))


def initial_state(scene):
    """The program's ParticleState of the scene's fluid: at rest, all alive."""
    from yasph2d_tpu_torch.world import ParticleState

    x = scene.fluid
    n = x.shape[0]
    return ParticleState(positions=x, velocities=torch.zeros_like(x),
                         densities=torch.zeros((n,), dtype=x.dtype, device=x.device),
                         alive=torch.ones((n,), dtype=torch.bool, device=x.device))


def boundary_dense(scene, solver):
    """The boundary's slot grid on the solver's grid, its slot count fitted
    to the fullest cell (`dense_boundary_occupancy` None, the config's
    default)."""
    from yasph2d_tpu_torch.models.dfsph_dense import build_boundary_dense

    return build_boundary_dense(scene.boundary, solver.grid, None)


def solver_knobs(cfg: dict, keys) -> dict:
    return {key: cfg["solver"][key] for key in keys}
