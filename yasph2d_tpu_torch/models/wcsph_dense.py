"""WCSPH on the dense slot grid (PyTorch port of yasph2d_tpu/models/
wcsph_dense.py; algorithm: Becker & Teschner 2007, reference
src/sph/solver/wscsph.rs:126-179), with two carries:

- `WCSPHPaddedSolver`, the padded-resident carry: the state stays in the
  (ny, nx, P[, 2]) slot layout between steps, and the rebuild is K4
  sm_rebucket (ops/sm_rebucket.py);
- `WCSPHDenseSolver`, the sorted carry (JAX `WCSPHDenseSolver`): the
  particles live in cell-sorted (N, ...) arrays; each step sorts them after
  the first half-kick (`sort_by_dense_keys`, stable), builds the slot grid,
  pads positions and velocities into it, runs the pair passes there and
  brings densities and accelerations back through `slots_to_sorted` (a
  particle without a slot takes rho0 and no pair force).

Both share `WCSPHSlotSolver`'s pair passes. Leapfrog, Tait EOS (gamma 7),
symmetric pressure forces with the Spiky kernel, Poly6 density, XSPH or
physical viscosity, Monaghan-Kajtar boundary penalty. Every pass runs on a
kernel that reads the slot layout in place;
`DenseGridConfig.use_pallas_slotmajor` picks the pair kernel of the three
passes (fluid Poly6 density, boundary density + penalty force against the
boundary, symmetric pressure + viscosity):

    True   K3 (ops/sm_pair_reduce.py) wcsph_density, wcsph_stat, wcsph_forces,
           in the JAX slot-major closures' order
    False  K5 (ops/pallas_pair.py), the same three forms in the JAX XLA
           closures' order (wcsph_dense.py:141-150, 189-197); on a grid with
           pair_dtype "bfloat16" in K5's bf16 math mode (the glue stays f32)

The forces form of PhysicalViscosityModel is wcsph_forces_phys on either
kernel (and on K1, models/wcsph_plane.py); any other model is refused.

Spatial sharding (parallel/shard_dense.py) takes the DFSPH padded solver's
hooks: the fluid's rows are exchanged once per step (after the rebuild),
the boundary's once at init, the force pass's source values (pressure,
density, velocity) once per step; K4 and K5 then run their halo forms.

The JAX package runs the boundary pass through the XLA dense_grid.pair_reduce
on both of its routes; here it is the route's kernel, so its f32 sums come in
the kernel's order and agree with the JAX package to f32 tolerance, not
bitwise.

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
    slots_to_sorted,
)
from ..ops.pair_reduce import PairForm
from ..ops.pallas_pair import bf16_consts, bf16_form, pallas_pair_reduce, rebase_of
from ..ops.sm_pair_reduce import sm_pair_reduce
from ..ops.sm_rebucket import sm_rebucket_parts
from ..ops.smoothing_kernels import Poly6, Spiky
from ..timemanager import StepConfig, TimeState, update_simulation_step
from ..units import REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import GRAVITY, FluidProperties, ParticleState
from .dfsph_dense import BoundaryDense, DFSPHSlotSolver
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
class WCSPHSlotSolver:
    """What the WCSPH slot-layout solvers share: the pair forms of the route
    and the three pair passes (`_density_and_forces`). The subclasses own the
    carry: WCSPHPaddedSolver (padded-resident), WCSPHDenseSolver (sorted) and,
    through the padded one, WCSPHPlaneSolver (planes)."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: DenseGridConfig
    step_config: StepConfig
    boundary_force_factor: float = 1.0  # wscsph.rs:35
    target_density_variation: float = 0.01
    expected_max_flow_speed: float = 1.0
    gravity: tuple = GRAVITY

    # K3 takes float32 only (K5 takes bf16 as its math mode); the plane
    # solver's K1 takes bf16 operands
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
        forms = self._make_forms(m, slotmajor)
        if not slotmajor and rebase_of(self.grid) is not None:  # K5's bf16 math mode
            object.__setattr__(self, "_consts", bf16_consts(self._consts))
            forms = WCSPHForms(*(bf16_form(f, self._consts) for f in forms))
        object.__setattr__(self, "_forms", forms)

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
        return self._max_vel_from_sq(torch.where(mask, v_est_sq, 0.0))

    # ------------------------------------------------------------ pair passes

    def _density_and_forces(self, pos, v, mask, boundary: BoundaryDense, dt):
        """The three pair passes (K3 or K5): Poly6 density with self-contribution
        and clamp, boundary density + Monaghan-Kajtar penalty in one pass
        (wscsph.rs:108-116), symmetric pressure + viscosity forces
        (wscsph.rs:59-105). Returns (dens (ny, nx, P), accel (ny, nx, P, 2))
        with accel EXCLUDING gravity."""
        f, pair = self._forms, self._slot_pair
        halo = self._halo((pos, mask))
        dyn_w = pair(f.density, pos, mask, pos, mask, halo)[..., 0]
        stat = pair(f.stat, pos, mask, boundary.pos_pad, boundary.mask, boundary.halo)
        dens = self._density(dyn_w, stat[..., 0])
        pres = tait_pressure(self.stiffness, self.properties.fluid_density, dens)
        accel_dyn = pair(f.forces, pos, mask, pos, mask, halo, q_vals=(pres, dens, v),
                         s_vals=(pres, dens, v), scalars=(float(dt),))
        return dens, accel_dyn + stat[..., 1:3]

    # the host loop of the DFSPH solvers: account each step's dt, then step;
    # their pair pass and the hooks of the shard solvers
    simulate = DFSPHSlotSolver.simulate
    _slot_pair = DFSPHSlotSolver._slot_pair
    _sort = DFSPHSlotSolver._sort
    _sum_counts = DFSPHSlotSolver._sum_counts
    _rebucket_row0 = DFSPHSlotSolver._rebucket_row0
    _halo = DFSPHSlotSolver._halo
    _max_vel_from_sq = DFSPHSlotSolver._max_vel_from_sq


@dataclass(frozen=True)
class WCSPHPaddedSolver(WCSPHSlotSolver):
    """WCSPH with the padded-resident carry: every pass through K3 or K5,
    the rebuild through K4."""

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
        pos, mask, (v,), drops = sm_rebucket_parts(pos, carry.mask, (v,), self.grid,
                                                   halo=self._halo((carry.mask, pos, v)))

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
            neighbor_drops=int(self._sum_counts(drops) + boundary.num_dropped),
        )
        return new_carry, diagnostics


class WCSPHDenseCarry(NamedTuple):
    """The sorted carry: particles in cell-sorted order and the accelerations
    the leapfrog carries across steps (wscsph.rs:21-22), in the same order."""

    particles: ParticleState
    accelerations: torch.Tensor  # (N, 2)
    time: TimeState


@dataclass(frozen=True)
class WCSPHDenseSolver(WCSPHSlotSolver):
    """WCSPH with the sorted carry (module docstring): a per-step sort and
    slot build instead of K4, the pair passes on K3 or K5."""

    def init_carry(self, state: ParticleState, boundary=None) -> WCSPHDenseCarry:
        """Zero accelerations (clear_cached_data, wscsph.rs:122-124); `boundary`
        is accepted as the other solvers' init_carry takes it, and ignored."""
        return WCSPHDenseCarry(particles=state,
                               accelerations=torch.zeros_like(state.velocities),
                               time=TimeState.initial(self.step_config))

    def export_state(self, carry: WCSPHDenseCarry) -> ParticleState:
        """The particles, N rows in cell order (`alive` marks the real ones)."""
        return carry.particles

    def step(self, carry: WCSPHDenseCarry, boundary: BoundaryDense):
        """One simulation step (reference: wscsph.rs:126-179), in the JAX
        sorted step's order."""
        g = self.grid
        particles, accel, time_state = carry
        dt = time_state.dt

        # leapfrog part 1 (wscsph.rs:141-151)
        velocities = particles.velocities + float(f32(0.5) * dt) * accel
        positions = particles.positions + velocities * float(dt)

        # sort + slot rebuild (dead particles take the sentinel key and leave
        # the grid), one matrix [pos | v | alive] through the sort
        packed = torch.cat([positions, velocities, particles.alive.to(REAL)[:, None]], 1)
        (packed,), sorted_keys = self._sort((packed,), packed[:, :2], particles.alive)
        positions, velocities = packed[:, :2], packed[:, 2:4]
        alive = packed[:, 4] > 0.5
        slots = build_slot_grid(sorted_keys, g)
        pv_pad = pad_to_slots(packed[:, :4], slots, g)
        mask = slots.slot_mask.reshape(g.ny, g.nx, g.occupancy)

        dens_pad, accel_pad = self._density_and_forces(
            pv_pad[..., :2].contiguous(), pv_pad[..., 2:4].contiguous(), mask, boundary, dt)
        # one unpad of [accel | density]; no slot: no pair force, rho0
        zeros1 = torch.zeros_like(positions[:, :1])
        out = slots_to_sorted(
            torch.cat([accel_pad, dens_pad[..., None]], dim=-1), slots, g,
            torch.cat([zeros1, zeros1, torch.full_like(zeros1, self.properties.fluid_density)],
                      1))
        gvec = torch.tensor(self.gravity, dtype=REAL, device=positions.device)
        # dead (padding) particles are frozen: no gravity, no advection
        accel = torch.where(alive[:, None], out[:, :2] + gvec[None, :], 0.0)

        # CFL with the *old* dt estimate (wscsph.rs:158-167), live particles only
        v_estimate = velocities + accel * float(dt)
        max_velocity = self._max_velocity((v_estimate * v_estimate).sum(dim=-1), alive)
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )

        # leapfrog part 2 with the NEW dt (wscsph.rs:169-178)
        velocities = velocities + float(f32(0.5) * time_state.dt) * accel

        new_carry = WCSPHDenseCarry(
            particles=ParticleState(positions, velocities, out[:, 2], alive),
            accelerations=accel,
            time=time_state,
        )
        return new_carry, Diagnostics.zeros()._replace(
            dt=dt, max_velocity=max_velocity,
            neighbor_drops=int(self._sum_counts(slots.num_dropped) + boundary.num_dropped))
