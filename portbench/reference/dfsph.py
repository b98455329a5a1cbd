"""One DFSPH step of the reference (Bender and Koschier; upstream
src/sph/solver/dfsph.rs:414-525) on particle lists: XSPH viscosity and
gravity, the CFL dt, the constant-density solve with its warm start,
advection, the pair context at the new positions and the divergence-free
solve with its warm start."""

from typing import NamedTuple

import numpy as np
import torch

from . import Consts, next_dt
from .kernels import poly6, wendland, wendland_zero
from .neighbors import Pairs, cells, pairs

ALPHA_EPSILON = 1e-6  # dfsph.rs:71
MIN_NEIGHBORS = 9  # particle-deficiency guard of the divergence solve, dfsph.rs:260-264
f32 = np.float32


class Ctx(NamedTuple):
    """What a DFSPH step derives from positions alone."""

    fluid: Pairs
    gc: torch.Tensor  # (N, C) Wendland gradient coefficient of the fluid pairs
    density: torch.Tensor  # (N,) with the self term, clamped to rho0
    alpha: torch.Tensor  # (N,)
    grad_boundary: torch.Tensor  # (N, 2) sum over boundary pairs of grad W
    neighbors: torch.Tensor  # (N,) fluid + boundary pair count


def context(x: torch.Tensor, boundary: torch.Tensor, k: Consts) -> Ctx:
    fl, bd = pairs(x, x, k), pairs(x, boundary, k)
    m = k.mass
    w_f, gc_f = wendland(fl.r, k.h)
    w_b, gc_b = wendland(bd.r, k.h)
    gfx, gfy = fl.sum(gc_f * fl.dx) * m, fl.sum(gc_f * fl.dy) * m
    gbx, gby = bd.sum(gc_b * bd.dx), bd.sum(gc_b * bd.dy)
    sq_f = fl.sum((gc_f * fl.dx * m) ** 2 + (gc_f * fl.dy * m) ** 2)
    sq_b = bd.sum((gc_b * bd.dx * m) ** 2 + (gc_b * bd.dy * m) ** 2)
    density = torch.clamp(m * (wendland_zero(k.h) + fl.sum(w_f) + bd.sum(w_b)), min=k.rho0)
    vx, vy = gfx + gbx * m, gfy + gby * m
    denom = vx * vx + vy * vy + sq_f + sq_b
    return Ctx(fluid=fl, gc=gc_f, density=density,
               alpha=1.0 / torch.clamp(denom, min=ALPHA_EPSILON),
               grad_boundary=torch.stack([gbx, gby], dim=-1),
               neighbors=(fl.valid.sum(1) + bd.valid.sum(1)).to(torch.float32))


def divergence(c: Ctx, v: torch.Tensor) -> torch.Tensor:
    """sum_j (v_i - v_j) . grad W_ij + v_i . sum_b grad W_ib (dfsph.rs:99-126)."""
    fl = c.fluid
    dv = v[:, None, :] - fl.gather(v)
    return fl.sum((dv[..., 0] * fl.dx + dv[..., 1] * fl.dy) * c.gc) + (
        v * c.grad_boundary).sum(-1)


def k_correction(c: Ctx, kk: torch.Tensor) -> torch.Tensor:
    """sum_j (k_i + k_j) grad W_ij + k_i sum_b grad W_ib (dfsph.rs:128-161)."""
    fl = c.fluid
    s = (kk[:, None] + fl.gather(kk)) * c.gc
    return torch.stack([fl.sum(s * fl.dx), fl.sum(s * fl.dy)], dim=-1) + (
        kk[:, None] * c.grad_boundary)


def viscosity(c: Ctx, v, rho, dt, k: Consts) -> torch.Tensor:
    """XSPH as an acceleration: sum_j eps m W6(r) / (rho_j dt) (v_j - v_i)."""
    fl = c.fluid
    coef = (k.xsph_epsilon * k.mass) * poly6(fl.r_sq, k.h) / (fl.gather(rho) * float(dt))
    dv = fl.gather(v) - v[:, None, :]
    return torch.stack([fl.sum(coef * dv[..., 0]), fl.sum(coef * dv[..., 1])], dim=-1)


def mean(values: torch.Tensor, n: int) -> np.float32:
    return f32(float(values.double().sum())) / f32(n)


def drops(x: torch.Tensor, k: Consts) -> int:
    """Particles beyond the program grid's slots a cell (K4's drop rule)."""
    cx, cy = cells(x, k)
    counts = torch.bincount(cy * k.nx + cx, minlength=k.nx * k.ny)
    return int(torch.clamp(counts - k.occupancy, min=0).sum())


def step(x, v, kappa, stiff, dt, prev_density_iterations, prev_divergence_iterations,
         boundary, k: Consts) -> dict:
    """One step from the state (positions, velocities, both warm starts, the
    current dt and the previous step's iteration counts)."""
    n = x.shape[0]
    rho0, m = f32(k.rho0), f32(k.mass)
    c0 = context(x, boundary, k)
    gravity = torch.tensor(k.gravity, dtype=x.dtype, device=x.device)
    accel = viscosity(c0, v, c0.density, dt, k) + gravity
    vstar = v + accel * float(dt)
    max_velocity = f32(float(torch.sqrt((vstar * vstar).sum(-1).max())))
    dt = next_dt(k, dt, max_velocity)
    v = v + accel * float(dt)

    # constant-density solve (dfsph.rs:484-496, 204-247)
    scale = float(f32(f32(1.0) / dt) * m)
    floor = float(f32(-0.5) * rho0 * rho0)
    if prev_density_iterations > 1:
        v = v - scale * k_correction(c0, 0.5 * torch.clamp(kappa, min=floor))
    kappa = torch.zeros_like(kappa)
    tol = f32(k.max_avg_density_error)
    density_iterations, avg = 0, f32(np.inf)
    while density_iterations == 0 or ((avg / rho0) * dt >= tol
                                      and density_iterations <= k.max_density_iterations):
        err = torch.clamp(c0.density + divergence(c0, v) * float(m) * float(dt),
                          min=float(rho0)) - float(rho0)
        ki = err * c0.alpha
        kappa = kappa + ki
        v = v - scale * k_correction(c0, ki)
        avg = mean(err, n)
        density_iterations += 1

    x = x + v * float(dt)
    n_dropped = drops(x, k)
    c1 = context(x, boundary, k)

    # divergence-free solve (dfsph.rs:521, 249-280)
    if prev_divergence_iterations > 1:
        v = v - float(m) * k_correction(c1, 0.5 * torch.clamp(stiff, min=floor))
    stiff = torch.zeros_like(stiff)
    tol = f32(k.max_divergence_error)
    divergence_iterations, avg = 0, f32(np.inf)
    while divergence_iterations == 0 or (avg * dt >= tol and divergence_iterations
                                         <= k.max_divergence_iterations):
        delta = torch.clamp(divergence(c1, v) * float(m), min=0.0)
        delta = torch.where(c1.neighbors < MIN_NEIGHBORS, 0.0, delta)
        ki = delta * c1.alpha
        stiff = stiff + ki
        v = v - float(m) * k_correction(c1, ki)
        avg = mean(delta, n) / rho0
        divergence_iterations += 1

    return dict(x=x, v=v, kappa=kappa, stiff=stiff, dt=dt, max_velocity=max_velocity,
                density_iterations=density_iterations,
                divergence_iterations=divergence_iterations, drops=n_dropped,
                density_before=c0.density, alpha_before=c0.alpha)
