"""Viscosity models: per-pair viscous acceleration (PyTorch port of
yasph2d_tpu/models/viscosity.py; reference: src/sph/viscositymodel/).

Both models have the form acceleration = c * (v_j - v_i); `viscous_coefficient`
returns c and is what the pair passes' twins consume. The CUDA pair kernels
(csrc/pair_terms.cuh XsphCoef, PhysCoef) compute both coefficients in the same
operation order; `kernel_coefficient` names a model's call forms and
constants. Any other model is refused by every solver, on every device.
"""

from dataclasses import dataclass

from ..ops.smoothing_kernels import Poly6, Viscosity


@dataclass(frozen=True)
class ViscosityModel:
    """Interface (reference: viscositymodel/mod.rs:11-18)."""

    def compute_viscous_acceleration(self, dt, r_sq, r, mass_j, rho_j, velocity_diff):
        """c (v_j - v_i) on (..., 2) pair tiles (the table solvers' form);
        `velocity_diff` is v_j - v_i."""
        return self.viscous_coefficient(dt, r_sq, r, mass_j, rho_j)[..., None] * velocity_diff

    def viscous_coefficient(self, dt, r_sq, r, mass_j, rho_j):
        raise NotImplementedError


@dataclass(frozen=True)
class XSPHViscosityModel(ViscosityModel):
    """XSPH velocity smoothing recast as an acceleration (divide by dt).
    Reference: viscositymodel/xsph.rs; default epsilon 0.05."""

    smoothing_length: float
    epsilon: float = 0.05

    def __post_init__(self):
        object.__setattr__(self, "kernel", Poly6(self.smoothing_length))

    def viscous_coefficient(self, dt, r_sq, r, mass_j, rho_j):
        return (
            float(self.epsilon * mass_j)
            * self.kernel.evaluate(r_sq, r)
            / (rho_j * dt)
        )


@dataclass(frozen=True)
class PhysicalViscosityModel(ViscosityModel):
    """Mueller laplacian viscosity (reference: viscositymodel/physical.rs);
    fluid_viscosity is the dynamic viscosity mu in Pa*s (default: water at 20C)."""

    smoothing_length: float
    fluid_viscosity: float = 1.0016 / 1000.0

    def __post_init__(self):
        object.__setattr__(self, "kernel", Viscosity(self.smoothing_length))

    def viscous_coefficient(self, dt, r_sq, r, mass_j, rho_j):
        return (
            float(self.fluid_viscosity * mass_j)
            * self.kernel.laplacian(r_sq, r)
            / rho_j
        )


def kernel_coefficient(model: ViscosityModel, mass: float):
    """(form suffix, PairConsts fields) of the CUDA kernels' viscosity
    coefficient for `model` and particle mass `mass`: XSPH forms have no
    suffix, the physical ones "_phys". Each constant is rounded to f32 where
    the twin's tensor operation rounds it. Raises NotImplementedError for any
    other model."""
    if isinstance(model, XSPHViscosityModel):
        return "", dict(p6_hsq=model.kernel._hsq, p6_norm=model.kernel._norm,
                        xsph_coef=float(model.epsilon * mass))
    if isinstance(model, PhysicalViscosityModel):
        return "_phys", dict(mu_m=float(model.fluid_viscosity * mass),
                             vl_h=float(model.kernel.h), vl_norm=model.kernel._norm_lapl)
    raise NotImplementedError(
        f"{type(model).__name__}: the pair kernels implement XSPHViscosityModel and "
        "PhysicalViscosityModel only")
