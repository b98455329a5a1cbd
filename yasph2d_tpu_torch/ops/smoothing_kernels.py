"""SPH smoothing kernels (PyTorch port of yasph2d_tpu/ops/smoothing_kernels.py).

Each kernel is a frozen dataclass holding the smoothing length `h` and its
normalizers as Python floats. Torch multiplies a float32 tensor by a Python
float in float32 after rounding the float once, exactly as JAX's weak typing
does, so the f32 operation sequence below is the JAX package's, op for op. The
CUDA pair kernel (csrc/pair_reduce.cu) evaluates the same formulas in the same
order from the float32-rounded normalizers.

Conventions (reference: smoothing_kernel/kernel.rs:8-34):
- support radius == h; evaluate/gradient return exact zeros outside support;
- ``evaluate(r_sq, r)`` takes both the squared and plain distance;
- ``gradient_coefficient(r_sq, r)`` is the scalar c >= 0 with
  grad_i W == c * (r_j - r_i);
- ``laplacian`` exists only on the Viscosity kernel.
"""

import math
from dataclasses import dataclass

import torch

from ..units import DIVISION_EPSILON


@dataclass(frozen=True)
class SmoothingKernel:
    """Base class: stores smoothing length; subclasses precompute normalizers."""

    h: float

    def evaluate(self, r_sq, r):
        raise NotImplementedError

    def gradient_coefficient(self, r_sq, r):
        """The scalar c >= 0 with gradient == c * ri_to_rj (kernel.rs:22-28)."""
        raise NotImplementedError

    def gradient(self, ri_to_rj, r_sq, r):
        """dW/d(r_i): ``c(r) * ri_to_rj``; ri_to_rj shape (..., 2)."""
        return self.gradient_coefficient(r_sq, r)[..., None] * ri_to_rj

    def laplacian(self, r_sq, r):
        raise NotImplementedError


@dataclass(frozen=True)
class Poly6(SmoothingKernel):
    """Mueller et al. density kernel; 2D normalizers (reference: poly6.rs:14-24)."""

    def __post_init__(self):
        h = float(self.h)
        object.__setattr__(self, "_hsq", h * h)
        object.__setattr__(self, "_norm", 4.0 / (math.pi * h**8))
        object.__setattr__(self, "_norm_grad", 24.0 / (math.pi * h**8))

    def evaluate(self, r_sq, r):
        dsq = torch.clamp(self._hsq - r_sq, min=0.0)
        return self._norm * dsq * dsq * dsq

    def gradient_coefficient(self, r_sq, r):
        dsq = torch.clamp(self._hsq - r_sq, min=0.0)
        return self._norm_grad * dsq * dsq


@dataclass(frozen=True)
class Spiky(SmoothingKernel):
    """Debrun's spiky pressure kernel; 2D normalizers (reference: spiky.rs:14-24)."""

    def __post_init__(self):
        h = float(self.h)
        object.__setattr__(self, "_norm", 10.0 / (math.pi * h**5))
        object.__setattr__(self, "_norm_grad", 30.0 / (math.pi * h**5))

    def evaluate(self, r_sq, r):
        hsubr = torch.clamp(self.h - r, min=0.0)
        return self._norm * hsubr * hsubr * hsubr

    def gradient_coefficient(self, r_sq, r):
        hsubr = torch.clamp(self.h - r, min=0.0)
        return self._norm_grad * hsubr * hsubr / (r + DIVISION_EPSILON)


@dataclass(frozen=True)
class CubicSpline(SmoothingKernel):
    """Monaghan 1992 cubic spline (reference: cubic.rs:16-52), piecewise in q = r/h."""

    def __post_init__(self):
        h = float(self.h)
        object.__setattr__(self, "_h_inv", 1.0 / h)
        object.__setattr__(self, "_norm", 6.0 * 40.0 / (7.0 * math.pi * h * h))
        object.__setattr__(self, "_norm_grad", 6.0 * 40.0 / (7.0 * math.pi * h**3))

    def evaluate(self, r_sq, r):
        q = r * self._h_inv
        q_sq = q * q
        inner = (1.0 / 6.0) + q_sq * q - q_sq
        one_minus_q = 1.0 - q
        outer = one_minus_q * one_minus_q * one_minus_q * (2.0 / 6.0)
        w = torch.where(q <= 0.5, inner, torch.where(q <= 1.0, outer, 0.0))
        return self._norm * w

    def gradient_coefficient(self, r_sq, r):
        q = r * self._h_inv
        # DIVISION_EPSILON keeps coincident pair slots NaN free (the reference
        # divides by r unguarded, cubic.rs:44-47; live pairs have r_sq > 1e-10)
        r_safe = r + DIVISION_EPSILON
        inner = q * (2.0 - q * 3.0) / r_safe
        factor = 1.0 - q
        outer = factor * factor / r_safe
        c = torch.where(q <= 0.5, inner, torch.where(q < 1.0, outer, 0.0))
        return self._norm_grad * c


@dataclass(frozen=True)
class WendlandQuinticC2(SmoothingKernel):
    """Wendland quintic C2 (reference: wendland_quintic_c2.rs:16-47), the DFSPH
    kernel."""

    def __post_init__(self):
        h = float(self.h)
        object.__setattr__(self, "_h_inv", 1.0 / h)
        object.__setattr__(self, "_norm", 4.0 * 7.0 / (math.pi * h * h))
        object.__setattr__(self, "_norm_grad", 140.0 / (math.pi * h**4))

    def evaluate(self, r_sq, r):
        q = torch.clamp(r * self._h_inv, max=1.0)
        one_minus_q = 1.0 - q
        omq_sq = one_minus_q * one_minus_q
        return self._norm * omq_sq * omq_sq * (q + 0.25)

    def gradient_coefficient(self, r_sq, r):
        q = torch.clamp(r * self._h_inv, max=1.0)
        one_minus_q = 1.0 - q
        return self._norm_grad * one_minus_q * one_minus_q * one_minus_q


@dataclass(frozen=True)
class Viscosity(SmoothingKernel):
    """Laplacian-only viscosity kernel (reference: viscosity.rs:11-48); `gradient`
    is unimplemented, as in the reference."""

    def __post_init__(self):
        h = float(self.h)
        object.__setattr__(self, "_hsq", h * h)
        object.__setattr__(self, "_norm", 90.0 / (29.0 * math.pi * h * h))
        object.__setattr__(self, "_norm_lapl", 360.0 / (29.0 * math.pi * h**5))

    def evaluate(self, r_sq, r):
        w = self._norm * (4.0 * r_sq * r / (9.0 * self.h) + r_sq) / self._hsq
        return torch.where(r < self.h, w, 0.0)

    def laplacian(self, r_sq, r):
        # like the reference (viscosity.rs:45-47): no clamp outside the support
        return self._norm_lapl * (self.h - r)


ALL_KERNELS = (Poly6, Spiky, CubicSpline, WendlandQuinticC2)
