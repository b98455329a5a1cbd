"""One WCSPH step of the reference (Becker and Teschner 2007; upstream
src/sph/solver/wscsph.rs:126-179) on particle lists: leapfrog half-kick and
drift, Poly6 density with the boundary, the Tait pressure, symmetric Spiky
pressure forces, XSPH viscosity, the Monaghan-Kajtar boundary penalty,
gravity, the CFL dt and the second half-kick."""

import numpy as np
import torch

from . import Consts, next_dt
from .dfsph import drops
from .kernels import poly6, poly6_zero, spiky
from .neighbors import pairs

f32 = np.float32


def step(x, v, accel, dt, boundary, k: Consts) -> dict:
    """One step from the state (positions, velocities, the accelerations of
    the previous step, the current dt)."""
    m = k.mass
    v = v + float(f32(0.5) * dt) * accel
    x = x + v * float(dt)
    n_dropped = drops(x, k)
    fl, bd = pairs(x, x, k), pairs(x, boundary, k)
    density = torch.clamp(m * (poly6_zero(k.h) + fl.sum(poly6(fl.r_sq, k.h))
                               + bd.sum(poly6(bd.r_sq, k.h))), min=k.rho0)
    ratio = torch.clamp(density / k.rho0, min=1.0)
    pressure = k.stiffness * (ratio ** 7 - 1.0)

    # symmetric pressure force and XSPH viscosity over the fluid (wscsph.rs:59-105)
    p_j, rho_j, v_j = fl.gather(pressure), fl.gather(density), fl.gather(v)
    coef = -m * (pressure[:, None] + p_j) / (2.0 * density[:, None] * rho_j)
    gc = coef * spiky(fl.r, k.h)[1]
    visc = (k.xsph_epsilon * m) * poly6(fl.r_sq, k.h) / (rho_j * float(dt))
    dv = v_j - v[:, None, :]
    fx = fl.sum(gc * fl.dx + visc * dv[..., 0])
    fy = fl.sum(gc * fl.dy + visc * dv[..., 1])
    # boundary penalty (wscsph.rs:108-116)
    pen = -k.boundary_force_factor * spiky(bd.r, k.h)[0] / bd.r_sq
    gravity = torch.tensor(k.gravity, dtype=x.dtype, device=x.device)
    accel = torch.stack([fx + bd.sum(pen * bd.dx), fy + bd.sum(pen * bd.dy)], -1) + gravity

    vstar = v + accel * float(dt)
    max_velocity = f32(float(torch.sqrt((vstar * vstar).sum(-1).max())))
    dt = next_dt(k, dt, max_velocity)
    v = v + float(f32(0.5) * dt) * accel
    return dict(x=x, v=v, accel=accel, density=density, dt=dt, max_velocity=max_velocity,
                drops=n_dropped)
