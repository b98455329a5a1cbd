"""The smoothing kernels of the upstream solvers, 2D, support h
(smoothing_kernel/*.rs): Wendland quintic C2 for DFSPH, Poly6 for the WCSPH
density and XSPH, Spiky for the WCSPH pressure. `grad_i W = gc (x_j - x_i)`."""

import math

import torch

DIVISION_EPSILON = 1.0e-10  # smoothing_kernel/kernel.rs:9


def wendland(r: torch.Tensor, h: float):
    """(W, gc) of the Wendland quintic C2 kernel."""
    q = torch.clamp(r / h, max=1.0)
    omq = 1.0 - q
    w = (28.0 / (math.pi * h * h)) * omq ** 4 * (q + 0.25)
    return w, (140.0 / (math.pi * h ** 4)) * omq ** 3


def wendland_zero(h: float) -> float:
    """W(0) of the Wendland kernel, the density's self term."""
    return 28.0 / (math.pi * h * h) * 0.25


def poly6(r_sq: torch.Tensor, h: float) -> torch.Tensor:
    d = torch.clamp(h * h - r_sq, min=0.0)
    return (4.0 / (math.pi * h ** 8)) * d ** 3


def poly6_zero(h: float) -> float:
    return 4.0 / (math.pi * h ** 8) * h ** 6


def spiky(r: torch.Tensor, h: float):
    """(W, gc) of the Spiky kernel."""
    d = torch.clamp(h - r, min=0.0)
    w = (10.0 / (math.pi * h ** 5)) * d ** 3
    return w, (30.0 / (math.pi * h ** 5)) * d * d / (r + DIVISION_EPSILON)
