"""Physical viscosity in the port's solvers: the kernels' coefficient
constants and call forms per viscosity model, against the JAX package's
coefficient on the CPU, and the refusal of any other model on every solver
and device.

The coefficient c = f32(mu m) * (f32(norm_lapl) * (f32(h) - r)) / rho_j
(JAX models/viscosity.py:73-78) is evaluated from the PairConsts fields in
that operation order with numpy float32 and compared bit for bit with the
port's twin (`viscous_coefficient`) and with the JAX model, run eagerly (the
op order of the source; jitted XLA would contract). The solver-level
comparisons with JAX are in tests/test_torch_config.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yasph2d_tpu_torch as y
from yasph2d_tpu.models.viscosity import PhysicalViscosityModel as JPhys
from yasph2d_tpu_torch.models.viscosity import ViscosityModel, kernel_coefficient
from yasph2d_tpu_torch.ops.cuda_build import PairConsts

SOLVERS = ["DFSPHPaddedSolver", "DFSPHPlaneSolver", "WCSPHPaddedSolver",
           "WCSPHPlaneSolver"]


def build(cls_name, viscosity, slotmajor=True):
    world = y.FluidParticleWorld(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    grid = dataclasses.replace(world.dense_grid(), use_pallas_slotmajor=slotmajor)
    return getattr(y, cls_name)(viscosity_model=viscosity, properties=world.properties,
                                grid=grid, step_config=y.FixedTimeStep(1.0 / 3000.0))


@pytest.mark.parametrize("cls_name", SOLVERS)
def test_forms_and_constants_follow_the_model(cls_name):
    h = 2.0 / 20.0
    xsph = build(cls_name, y.XSPHViscosityModel(h, epsilon=0.07))
    phys = build(cls_name, y.PhysicalViscosityModel(h, fluid_viscosity=0.01))
    form = {"DFSPHPaddedSolver": lambda s: s._forms.visc,
            "DFSPHPlaneSolver": lambda s: s._forms.visc_gravity,
            "WCSPHPaddedSolver": lambda s: s._forms.forces,
            "WCSPHPlaneSolver": lambda s: s._forms.forces}[cls_name]
    assert form(phys).name == form(xsph).name + "_phys"
    m = float(phys.properties.particle_mass)
    c = phys._consts
    assert (c.mu_m, c.vl_h, c.vl_norm) == tuple(float(np.float32(v)) for v in (
        0.01 * m, phys.viscosity_model.kernel.h, phys.viscosity_model.kernel._norm_lapl))
    assert xsph._consts.xsph_coef == float(np.float32(0.07 * m))
    assert (xsph._consts.mu_m, phys._consts.xsph_coef) == (0.0, 0.0)


def test_coefficient_matches_the_twin_and_jax_bitwise():
    h, m = 0.0789, 0.0312
    suffix, consts = kernel_coefficient(y.PhysicalViscosityModel(h, 0.01), m)
    assert suffix == "_phys"
    c = PairConsts(**consts)
    rng = np.random.default_rng(0)
    r = (rng.random(4096) * h).astype(np.float32)
    rho = (100.0 + 30.0 * rng.random(4096)).astype(np.float32)
    f32 = np.float32
    kernel_order = (f32(c.mu_m) * (f32(c.vl_norm) * (f32(c.vl_h) - r))) / rho
    twin = y.PhysicalViscosityModel(h, 0.01).viscous_coefficient(
        1e-3, torch.as_tensor(r * r), torch.as_tensor(r), m, torch.as_tensor(rho)).numpy()
    ref = np.asarray(JPhys(h, 0.01).viscous_coefficient(
        1e-3, jnp.asarray(r * r), jnp.asarray(r), m, jnp.asarray(rho)))
    np.testing.assert_array_equal(twin.view(np.uint32), kernel_order.view(np.uint32))
    np.testing.assert_array_equal(ref.view(np.uint32), kernel_order.view(np.uint32))


class Laminar(ViscosityModel):
    """A viscosity model no kernel implements."""

    def viscous_coefficient(self, dt, r_sq, r, mass_j, rho_j):
        return 0.0 * rho_j


@pytest.mark.parametrize("cls_name,slotmajor", [
    (name, sm) for name in SOLVERS for sm in (True, False)
    if sm or name.endswith("PaddedSolver")])  # the plane solvers require True
def test_other_viscosity_models_are_refused(cls_name, slotmajor):
    """On every solver and route, whatever the device its tensors will be on:
    the refusal comes at construction."""
    with pytest.raises(NotImplementedError, match="Laminar"):
        build(cls_name, Laminar(), slotmajor)
