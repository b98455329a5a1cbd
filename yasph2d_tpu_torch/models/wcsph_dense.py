"""WCSPH with the padded slot-major carry (PyTorch port of WCSPHPaddedSolver in
yasph2d_tpu/models/wcsph_dense.py; algorithm: Becker & Teschner 2007,
reference src/sph/solver/wscsph.rs:126-179).

Leapfrog, Tait EOS (gamma 7), symmetric pressure forces with the Spiky kernel,
Poly6 density, XSPH or physical viscosity, Monaghan-Kajtar boundary penalty.
The state stays in the (ny, nx, P[, 2]) slot layout between steps, and every
pass runs on a kernel that reads it in place. The rebuild is K4 sm_rebucket
(ops/sm_rebucket.py); `DenseGridConfig.use_pallas_slotmajor` picks the pair
kernel of the three passes (fluid Poly6 density, boundary density + penalty
force against the boundary, symmetric pressure + viscosity):

    True   K3 (ops/sm_pair_reduce.py) wcsph_density, wcsph_stat, wcsph_forces,
           in the JAX slot-major closures' order
    False  K5 (ops/pallas_pair.py), the same three forms in the JAX XLA
           closures' order (wcsph_dense.py:141-150, 189-197)

The forces form of PhysicalViscosityModel is wcsph_forces_phys on either
kernel (and on K1, models/wcsph_plane.py); any other model is refused.

The JAX package runs the boundary pass through the XLA dense_grid.pair_reduce
on both of its routes; here it is the route's kernel, so its f32 sums come in
the kernel's order and agree with the JAX package to f32 tolerance, not
bitwise. The sorted-carry WCSPHDenseSolver is not ported.

dt lives on the host as np.float32 (timemanager.py); each step reads the CFL
velocity and the drop count back from the device.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_build import PairConsts
from ..ops.dense_grid import (
    DenseGridConfig,
    build_slot_grid,
    pad_to_slots,
    require_float32_pairs,
)
from ..ops.pair_reduce import PairForm
from ..ops.pallas_pair import pallas_pair_reduce
from ..ops.sm_pair_reduce import sm_pair_reduce
from ..ops.sm_rebucket import sm_rebucket_parts
from ..ops.smoothing_kernels import Poly6, Spiky
from ..timemanager import StepConfig, TimeState, update_simulation_step
from ..units import REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import GRAVITY, FluidProperties, ParticleState
from .dfsph_dense import BoundaryDense, DFSPHPaddedSolver
from .viscosity import ViscosityModel, kernel_coefficient
from .wcsph import compute_stiffness, tait_pressure

f32 = REAL_NP


class WCSPHPaddedCarry(NamedTuple):
    """Padded-resident WCSPH state."""

    pos_pad: torch.Tensor  # (ny, nx, P, 2)
    v_pad: torch.Tensor  # (ny, nx, P, 2)
    accel_pad: torch.Tensor  # (ny, nx, P, 2) cached for the leapfrog (wscsph.rs:21-22)
    dens_pad: torch.Tensor  # (ny, nx, P) last computed densities
    mask: torch.Tensor  # (ny, nx, P) bool
    time: TimeState


class WCSPHForms(NamedTuple):
    """The three pair call forms of a WCSPH step: the CUDA instantiations'
    names and their math for the twins. K1 (plane) and K3 take the slot-major
    order, K5 the XLA order."""

    density: PairForm
    stat: PairForm
    forces: PairForm


@dataclass(frozen=True)
class WCSPHPaddedSolver:
    """WCSPH, padded slot-major carry, every pass through K3 or K5, and K4."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: DenseGridConfig
    step_config: StepConfig
    boundary_force_factor: float = 1.0  # wscsph.rs:35
    target_density_variation: float = 0.01
    expected_max_flow_speed: float = 1.0
    gravity: tuple = GRAVITY

    # the padded kernels K3 / K5 take float32 operands only; the plane
    # solver's K1 takes bf16 too
    _bf16_operands = False

    def __post_init__(self):
        if not self._bf16_operands:
            require_float32_pairs(self.grid, type(self).__name__)
        h = self.properties.smoothing_length
        assert abs(self.grid.cell_size - h) < 1e-12
        density_kernel, pressure_kernel = Poly6(h), Spiky(h)
        object.__setattr__(self, "density_kernel", density_kernel)
        object.__setattr__(self, "pressure_kernel", pressure_kernel)
        object.__setattr__(self, "stiffness", compute_stiffness(
            self.properties, self.target_density_variation,
            self.expected_max_flow_speed,
        ))
        m = float(self.properties.particle_mass)
        # W(0), the density self-contribution, evaluated in f32
        zero = torch.zeros((), dtype=REAL)
        object.__setattr__(self, "_w0", float(density_kernel.evaluate(zero, zero)))
        visc_suffix, visc_consts = kernel_coefficient(self.viscosity_model, m)
        object.__setattr__(self, "_visc_suffix", visc_suffix)
        object.__setattr__(self, "_consts", PairConsts(
            radius_sq=self.grid.radius_sq,
            **visc_consts,
            mass=m, rho0=self.properties.fluid_density,
            gx=float(self.gravity[0]), gy=float(self.gravity[1]),
            d6_hsq=density_kernel._hsq, d6_norm=density_kernel._norm,
            sp_h=h, sp_norm=pressure_kernel._norm,
            sp_norm_grad=pressure_kernel._norm_grad,
            bff=self.boundary_force_factor,
        ))
        slotmajor = self.grid.use_pallas_slotmajor
        object.__setattr__(self, "_reduce",
                           sm_pair_reduce if slotmajor else pallas_pair_reduce)
        object.__setattr__(self, "_forms", self._make_forms(m, slotmajor))

    def _make_forms(self, m: float, slotmajor: bool) -> WCSPHForms:
        """The pair terms as Python callables (the twins'), op for op the JAX
        closures of models/wcsph_dense.py and models/wcsph_plane.py: the
        slot-major forces on K3 and K1, the XLA ones (coef (gc dx)) on K5."""
        dk, pk = self.density_kernel, self.pressure_kernel
        bff = self.boundary_force_factor
        visc = self.viscosity_model

        def density_terms(dx, dy, r_sq, r, scalars, q, s):
            return (dk.evaluate(r_sq, r),)

        def stat_terms(dx, dy, r_sq, r, scalars, q, s):
            w_b = pk.evaluate(r_sq, r)
            c = -bff * w_b / r_sq
            return (dk.evaluate(r_sq, r), c * dx, c * dy)

        def force_terms(dx, dy, r_sq, r, scalars, q, s):
            p_i, rho_i, vx_i, vy_i = q
            p_j, rho_j, vx_j, vy_j = s
            coef = -m * (p_i + p_j) / (2.0 * rho_i * rho_j)
            gc = coef * pk.gradient_coefficient(r_sq, r)
            c = visc.viscous_coefficient(scalars[0], r_sq, r, m, rho_j)
            return (gc * dx + c * (vx_j - vx_i), gc * dy + c * (vy_j - vy_i))

        def force_terms_xla(dx, dy, r_sq, r, scalars, q, s):
            p_i, rho_i, vx_i, vy_i = q
            p_j, rho_j, vx_j, vy_j = s
            coef = -m * (p_i + p_j) / (2.0 * rho_i * rho_j)
            gc = pk.gradient_coefficient(r_sq, r)
            c = visc.viscous_coefficient(scalars[0], r_sq, r, m, rho_j)
            return (coef * (gc * dx) + c * (vx_j - vx_i),
                    coef * (gc * dy) + c * (vy_j - vy_i))

        return WCSPHForms(
            density=PairForm("wcsph_density", 1, density_terms),
            stat=PairForm("wcsph_stat", 3, stat_terms),
            forces=PairForm("wcsph_forces" + self._visc_suffix, 2,
                            force_terms if slotmajor else force_terms_xla),
        )

    def _density(self, dyn_w, stat_w):
        """m (W(0) + dyn + stat), clamped to rho0 (fluidparticleworld.rs:197-231)."""
        m = float(self.properties.particle_mass)
        dens = m * ((self._w0 + dyn_w) + stat_w)
        return torch.clamp(dens, min=self.properties.fluid_density)

    def _max_velocity(self, v_est_sq, mask) -> np.float32:
        """CFL velocity from squared speeds; live slots only."""
        return f32(float(torch.sqrt(torch.where(mask, v_est_sq, 0.0).max())))

    # ------------------------------------------------------------ pair passes

    def _density_and_forces(self, pos, v, mask, boundary: BoundaryDense, dt):
        """The three pair passes (K3 or K5): Poly6 density with self-contribution
        and clamp, boundary density + Monaghan-Kajtar penalty in one pass
        (wscsph.rs:108-116), symmetric pressure + viscosity forces
        (wscsph.rs:59-105). Returns (dens (ny, nx, P), accel (ny, nx, P, 2))
        with accel EXCLUDING gravity."""
        f, c, reduce = self._forms, self._consts, self._reduce
        dyn_w = reduce(f.density, pos, mask, pos, mask, c)[..., 0]
        stat = reduce(f.stat, pos, mask, boundary.pos_pad, boundary.mask, c)
        dens = self._density(dyn_w, stat[..., 0])
        pres = tait_pressure(self.stiffness, self.properties.fluid_density, dens)
        accel_dyn = reduce(f.forces, pos, mask, pos, mask, c,
                           q_vals=(pres, dens, v), s_vals=(pres, dens, v),
                           scalars=(float(dt),))
        return dens, accel_dyn + stat[..., 1:3]

    # ------------------------------------------------------------- host bounds

    def init_carry(self, state: ParticleState, boundary=None) -> WCSPHPaddedCarry:
        """Cell-sort, slot grid, padded positions and velocities, zero cached
        accelerations (clear_cached_data, wscsph.rs:122-124). `boundary` is
        accepted so that every solver's init_carry takes the same arguments,
        and ignored."""
        g = self.grid
        (positions, velocities), sorted_keys = self._sort(
            (state.positions, state.velocities), state.positions, state.alive
        )
        slots = build_slot_grid(sorted_keys, g)
        mask = slots.slot_mask.reshape(g.ny, g.nx, g.occupancy)
        pos_pad = pad_to_slots(positions, slots, g)
        return WCSPHPaddedCarry(
            pos_pad=pos_pad,
            v_pad=torch.where(mask[..., None], pad_to_slots(velocities, slots, g), 0.0),
            accel_pad=torch.zeros_like(pos_pad),
            dens_pad=torch.full(mask.shape, self.properties.fluid_density, dtype=REAL,
                                device=mask.device),
            mask=mask,
            time=TimeState.initial(self.step_config),
        )

    def export_state(self, carry: WCSPHPaddedCarry) -> ParticleState:
        """Flat slot-order view: N = ny*nx*P rows with the slot mask as `alive`."""
        mask = carry.mask.reshape(-1)
        return ParticleState(
            positions=carry.pos_pad.reshape(-1, 2),
            velocities=torch.where(mask[:, None], carry.v_pad.reshape(-1, 2), 0.0),
            densities=torch.where(mask, carry.dens_pad.reshape(-1),
                                  self.properties.fluid_density),
            alive=mask,
        )

    # the host loop of the DFSPH solvers: account each step's dt, then step;
    # their init-time sort and counter sum, the hooks of the shard solvers
    simulate = DFSPHPaddedSolver.simulate
    _sort = DFSPHPaddedSolver._sort
    _sum_counts = DFSPHPaddedSolver._sum_counts

    # -------------------------------------------------------------------- step

    def step(self, carry: WCSPHPaddedCarry, boundary: BoundaryDense):
        """One simulation step (reference: wscsph.rs:126-179), in the JAX step's
        order."""
        time_state = carry.time
        dt = time_state.dt

        # leapfrog part 1 in the OLD layout (wscsph.rs:141-151)
        v = carry.v_pad + float(f32(0.5) * dt) * carry.accel_pad
        pos = carry.pos_pad + v * float(dt)

        # neighbourhood rebuild = windowed re-bucket (wscsph.rs:153)
        pos, mask, (v,), drops = sm_rebucket_parts(pos, carry.mask, (v,), self.grid)

        dens, accel = self._density_and_forces(pos, v, mask, boundary, dt)
        gvec = torch.tensor(self.gravity, dtype=REAL, device=pos.device)
        # dead slots stay frozen: no gravity, no advection
        accel = torch.where(mask[..., None], accel + gvec, 0.0)

        # CFL with the *old* dt estimate (wscsph.rs:158-167)
        vstar = v + accel * float(dt)
        max_velocity = self._max_velocity((vstar * vstar).sum(dim=-1), mask)
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )

        # leapfrog part 2 with the NEW dt (wscsph.rs:169-178)
        v = v + float(f32(0.5) * time_state.dt) * accel

        new_carry = WCSPHPaddedCarry(
            pos_pad=pos, v_pad=v, accel_pad=accel, dens_pad=dens, mask=mask,
            time=time_state,
        )
        diagnostics = Diagnostics.zeros()._replace(
            dt=dt,
            max_velocity=max_velocity,
            neighbor_drops=int(drops + boundary.num_dropped),
        )
        return new_carry, diagnostics
