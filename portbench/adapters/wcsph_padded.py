"""The WCSPH padded solver (`WCSPHPaddedSolver`, kind "wcsph_padded"): K5
pair passes and the K4 re-bucket."""

from . import PairCall, Step, System
from .common import boundary_dense, initial_state, solver_kwargs, solver_knobs

KNOBS = ("boundary_force_factor", "target_density_variation", "expected_max_flow_speed")


def build(cfg: dict, scene, device, pair_dtype: str) -> System:
    from yasph2d_tpu_torch.config import build_solver

    solver = build_solver("wcsph_padded", None, **solver_kwargs(cfg, scene, pair_dtype),
                          **solver_knobs(cfg, KNOBS))
    boundary = boundary_dense(scene, solver)
    return System(solver, boundary, solver.init_carry(initial_state(scene), boundary))


def step(system: System, carry):
    carry = carry._replace(time=carry.time.account_step())
    carry, d = system.solver.step(carry, system.boundary)
    return carry, Step(float(d.dt), 0, 0, int(d.neighbor_drops))


def state(system: System, carry) -> dict:
    return dict(pos=carry.pos_pad, mask=carry.mask, vel=carry.v_pad, accel=carry.accel_pad,
                density=carry.dens_pad, dt=carry.time.dt)


def k5_calls(system: System, carry) -> list:
    """The padded WCSPH step's K5 passes (models/wcsph_dense.py): fluid
    density, boundary density and penalty, pressure and viscosity forces
    (query and source values: pressure, density, velocity)."""
    b = system.boundary
    pos, mask = carry.pos_pad, carry.mask
    shape = tuple(mask.shape)
    rho, v = carry.dens_pad, carry.v_pad
    fluid = (pos, mask, pos, mask)
    return [
        PairCall("WcsphDensityTerm", "wcsph_density", (pos,), (pos,), (mask,),
                 (shape + (1,),), *fluid),
        PairCall("WcsphStatTerm", "wcsph_stat", (pos,), (b.pos_pad,), (mask, b.mask),
                 (shape + (3,),), pos, mask, b.pos_pad, b.mask),
        # the pressure plane has the density's layout; counted as the density
        PairCall("WcsphForcesXlaTerm<XsphCoef", "wcsph_forces", (pos, rho, rho, v),
                 (pos, rho, rho, v), (mask,), (shape + (2,),), *fluid),
    ]


def k4_call(system: System, carry):
    """(positions, mask, payload, output shapes) of the step's re-bucket: the
    payload is the half-kicked velocity."""
    shape = tuple(carry.mask.shape)
    return carry.pos_pad, carry.mask, carry.v_pad, (shape + (2,), shape, shape + (2,))
