"""The DFSPH padded solver (`DFSPHPaddedSolver`, kind "dfsph_padded"): the
config's default kind, K5 pair passes and the K4 re-bucket."""

import torch

from . import PairCall, Step, System
from .common import boundary_dense, initial_state, solver_kwargs, solver_knobs

KNOBS = ("max_avg_density_error", "max_density_iterations", "max_divergence_error",
         "max_divergence_iterations", "rebuild_every")


def build(cfg: dict, scene, device, pair_dtype: str) -> System:
    from yasph2d_tpu_torch.config import build_solver

    solver = build_solver("dfsph_padded", None, **solver_kwargs(cfg, scene, pair_dtype),
                          **solver_knobs(cfg, KNOBS))
    boundary = boundary_dense(scene, solver)
    return System(solver, boundary, solver.init_carry(initial_state(scene), boundary))


def step(system: System, carry):
    carry = carry._replace(time=carry.time.account_step())
    carry, d = system.solver.step(carry, system.boundary)
    return carry, Step(float(d.dt), int(d.density_iterations), int(d.divergence_iterations),
                       int(d.neighbor_drops))


def state(system: System, carry) -> dict:
    c = carry.ctx
    return dict(pos=c.pos_pad, mask=c.mask, vel=carry.v_pad, kappa=carry.kappa_pad,
                stiff=carry.stiff_pad, density=c.densities_pad, alpha=c.alpha_pad,
                drops=int(c.num_dropped), dt=carry.time.dt,
                prev_density_iterations=carry.prev_density_iterations,
                prev_divergence_iterations=carry.prev_divergence_iterations)


def k5_calls(system: System, carry) -> list:
    """The padded DFSPH step's K5 passes (models/dfsph_dense.py): the ctx
    pass to the fluid and to the boundary (one functor), divergence,
    k-correction and XSPH viscosity. The loop passes read one value and
    write one (div) or two (corr) planes a slot."""
    c, b = carry.ctx, system.boundary
    pos, mask = c.pos_pad, c.mask
    shape = tuple(mask.shape)
    v, k, rho = carry.v_pad, carry.kappa_pad, c.densities_pad
    fluid = (pos, mask, pos, mask)
    return [
        PairCall("CtxXlaTerm", "dfsph_ctx", (pos,), (pos,), (mask,), (shape + (5,),), *fluid),
        PairCall("CtxXlaTerm", "dfsph_stat", (pos,), (b.pos_pad,), (mask, b.mask),
                 (shape + (5,),), pos, mask, b.pos_pad, b.mask),
        PairCall("DivXlaTerm", "dfsph_div", (pos, v), (pos, v), (mask,), (shape + (1,),),
                 *fluid),
        PairCall("CorrXlaTerm", "dfsph_corr", (pos, k), (pos, k), (mask,), (shape + (2,),),
                 *fluid),
        PairCall("ViscTerm<XsphCoef", "dfsph_visc", (pos, v), (pos, v, rho), (mask,),
                 (shape + (2,),), *fluid),
    ]


def k4_call(system: System, carry):
    """(positions, mask, payload, output shapes) of the step's re-bucket: the
    payload [v*(2) | kappa | stiffness]."""
    c = carry.ctx
    payload = torch.cat([carry.v_pad, carry.kappa_pad[..., None], carry.stiff_pad[..., None]],
                        dim=-1)
    shape = tuple(c.mask.shape)
    return c.pos_pad, c.mask, payload, (shape + (2,), shape, shape + (4,))
