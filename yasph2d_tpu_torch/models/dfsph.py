"""DFSPH on neighbour tables (PyTorch port of yasph2d_tpu/models/dfsph.py;
Bender & Koschier, "Divergence-Free SPH for Incompressible and Viscous
Fluids", reference: src/sph/solver/dfsph.rs).

The table layout of the JAX package, the reference app's default solver
(main.rs:91): each step's post-advection rebuild re-sorts the particles by
cell key and builds their (N, K) neighbour tables (world.update_neighborhood);
every pair pass is a gather through the tables and a masked sum over K, in
plain tensor operations (the JAX package runs this layout in plain XLA, no
Pallas kernel). The step, in the JAX step's operation order (dfsph.rs):

- warm-up on a new particle set (:419-428)        -> `init_carry`
- compute_alpha_factors (:68-97)                  -> `_alpha_from_tables`
- non-pressure forces over the fluid table (:437-469), the CFL update with
  the old-dt velocity estimate (:472-481), v* with the new dt (:484-492)
- correct_density_error (:163-247)                -> host loop
- advection (:499-510), rebuild co-sorting v* and both warm starts (:512)
- densities and alpha of the new tables (:516-518)
- correct_divergence_error (:282-402)             -> host loop

Kernel gradients of the live pairs do not change inside a pressure loop
(positions are frozen), so `_PairCache` holds them once per rebuild and a
loop iteration is two gathers and masked sums. The JAX `lax.while_loop`s are
host loops that read one residual back per iteration, with the JAX exit test
(a loop may run max + 1 times).

Deliberate divergence, as in the JAX package: the reference does not co-sort
warmstart_kappa / warmstart_stiffness when the rebuild permutes the particles
(dfsph.rs:512 passes only the predicted velocities), so its warm starts land
on other particles; both are co-sorted here.
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import pair
from ..ops.dense_grid import f32_scalar
from ..ops.neighborhood import CellGrid, GridConfig, Neighborhood
from ..ops.smoothing_kernels import WendlandQuinticC2
from ..timemanager import StepConfig, TimeState, update_simulation_step
from ..units import REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import (
    GRAVITY,
    FluidProperties,
    ParticleState,
    update_densities,
    update_neighborhood,
)
from .dfsph_dense import DFSPHSlotSolver
from .viscosity import ViscosityModel

f32 = REAL_NP

ALPHA_EPSILON = 1e-6  # reference: dfsph.rs:71


class DFSPHCarry(NamedTuple):
    """Step-to-step state. The tables, densities and alpha are those of the
    previous step's rebuild, which the step consumes first (dfsph.rs:437
    onward); the warm starts carry across steps, gated by the previous
    iteration counts (dfsph.rs:199, 354)."""

    particles: ParticleState  # sorted by cell key
    alpha: torch.Tensor  # (N,)
    warmstart_kappa: torch.Tensor  # (N,) density-loop stiffness sums
    warmstart_stiffness: torch.Tensor  # (N,) divergence-loop stiffness sums
    neighborhood: Neighborhood
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


class _PairCache(NamedTuple):
    """Per-pair quantities that are invariant while positions are frozen."""

    grad_dyn: torch.Tensor  # (N, Kd, 2) masked kernel gradients to fluid neighbours
    sum_grad_stat: torch.Tensor  # (N, 2) summed kernel gradients to boundary neighbours


@dataclass(frozen=True)
class DFSPHSolver:
    """DFSPH on neighbour tables (`grid` is the world's GridConfig, the
    boundary its `boundary_grid()`). Tolerances as dfsph.rs:49-55; the
    kernel is WendlandQuinticC2 (dfsph.rs:11)."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: GridConfig
    step_config: StepConfig
    max_avg_density_error: float = 0.01 / 100.0
    max_density_iterations: int = 200
    max_divergence_error: float = 0.1 / 100.0
    max_divergence_iterations: int = 400
    gravity: tuple = GRAVITY

    def __post_init__(self):
        object.__setattr__(self, "kernel",
                           WendlandQuinticC2(self.properties.smoothing_length))

    # ----------------------------------------------------------------- helpers

    def _pair_cache(self, positions, neighborhood, boundary_positions) -> _PairCache:
        dyn, stat = neighborhood.dynamic, neighborhood.static
        grad_dyn = self.kernel.gradient(
            *pair.pair_geometry(positions, pair.gather(positions, dyn.idx)))
        grad_dyn = torch.where(dyn.mask[..., None], grad_dyn, 0.0)
        grad_stat = self.kernel.gradient(
            *pair.pair_geometry(positions, pair.gather(boundary_positions, stat.idx)))
        return _PairCache(grad_dyn=grad_dyn,
                          sum_grad_stat=pair.masked_sum(grad_stat, stat.mask))

    def _alpha_from_tables(self, positions, boundary_positions, neighborhood,
                           cache: _PairCache) -> torch.Tensor:
        """alpha_i = 1 / max(|sum m grad|^2 + sum |m grad|^2, eps)
        (reference: compute_alpha_factors, dfsph.rs:68-97); the boundary
        gradients enter both sums, so they are evaluated once more here."""
        m = f32_scalar(self.properties.particle_mass)
        mgrad = cache.grad_dyn * m
        grad_sum = mgrad.sum(dim=1)
        grad_sq_sum = (mgrad * mgrad).sum(dim=-1).sum(dim=1)

        stat = neighborhood.static
        mgrad_s = self.kernel.gradient(*pair.pair_geometry(
            positions, pair.gather(boundary_positions, stat.idx))) * m
        mgrad_s = torch.where(stat.mask[..., None], mgrad_s, 0.0)
        grad_sum = grad_sum + mgrad_s.sum(dim=1)
        grad_sq_sum = grad_sq_sum + (mgrad_s * mgrad_s).sum(dim=-1).sum(dim=1)

        denom = (grad_sum * grad_sum).sum(dim=-1) + grad_sq_sum
        return 1.0 / torch.clamp(denom, min=ALPHA_EPSILON)

    def _k_correction(self, k, neighborhood, cache: _PairCache):
        """sum_dyn (k_i + k_j) grad_ij + k_i sum_stat grad_ij, (N, 2): the shape
        of every velocity correction (dfsph.rs:128-161, 163-193, 282-344)."""
        dyn = neighborhood.dynamic
        coef = torch.where(dyn.mask, k[:, None] + pair.gather(k, dyn.idx), 0.0)
        delta = (coef[..., None] * cache.grad_dyn).sum(dim=1)
        return delta + k[:, None] * cache.sum_grad_stat

    def _velocity_divergence(self, velocities, neighborhood, cache: _PairCache):
        """sum_dyn (v_i - v_j) . grad_ij + v_i . sum_stat grad_ij, (N,)
        (boundary particles are at rest; dfsph.rs:99-126, 249-280)."""
        dyn = neighborhood.dynamic
        dv = velocities[:, None, :] - pair.gather(velocities, dyn.idx)
        per_pair = (dv * cache.grad_dyn).sum(dim=-1)  # the gradients are masked
        delta = torch.where(dyn.mask, per_pair, 0.0).sum(dim=1)
        return delta + (velocities * cache.sum_grad_stat).sum(dim=-1)

    # ---------------------------------------------------------- pressure loops

    def _correct_density_error(self, dt, densities, alpha, velocities, kappa,
                               prev_iterations, neighborhood, cache: _PairCache,
                               n_live):
        """Constant-density loop with warm start (dfsph.rs:163-247); the
        residual averages over the `n_live` live particles (dfsph.rs:221).
        Returns (v, kappa sum, iterations, last average density error)."""
        rho0 = f32(self.properties.fluid_density)
        m = f32(self.properties.particle_mass)
        scale = float((f32(1.0) / dt) * m)
        tol = f32(self.max_avg_density_error)
        inv_n = f32(1.0) / n_live
        if prev_iterations > 1:  # warm start (dfsph.rs:197-206)
            k = 0.5 * torch.clamp(kappa, min=float(f32(-0.5) * rho0 * rho0))
            velocities = velocities - scale * self._k_correction(k, neighborhood, cache)
        k_sum = torch.zeros_like(kappa)
        num, avg = 0, f32(np.inf)
        while num == 0 or ((avg / rho0) * dt >= tol and num <= self.max_density_iterations):
            delta = self._velocity_divergence(velocities, neighborhood, cache)
            err = torch.clamp(densities + delta * float(m) * float(dt),
                              min=float(rho0)) - float(rho0)
            ki = err * alpha
            k_sum = k_sum + ki
            velocities = velocities - scale * self._k_correction(ki, neighborhood, cache)
            avg = f32(float(err.sum())) * inv_n
            num += 1
        return velocities, k_sum, num, avg

    def _correct_divergence_error(self, dt, alpha, velocities, stiffness,
                                  prev_iterations, neighborhood, cache: _PairCache,
                                  n_live):
        """Divergence-free loop with warm start (dfsph.rs:282-402)."""
        rho0 = f32(self.properties.fluid_density)
        m = float(f32(self.properties.particle_mass))
        tol = f32(self.max_divergence_error)
        inv_n = f32(1.0) / n_live
        total_neighbors = neighborhood.dynamic.count + neighborhood.static.count
        if prev_iterations > 1:  # warm start
            s = 0.5 * torch.clamp(stiffness, min=float(f32(-0.5) * rho0 * rho0))
            velocities = velocities - m * self._k_correction(s, neighborhood, cache)
        s_sum = torch.zeros_like(stiffness)
        num, avg = 0, f32(np.inf)
        while num == 0 or (avg * dt >= tol and num <= self.max_divergence_iterations):
            delta = self._velocity_divergence(velocities, neighborhood, cache) * m
            delta = torch.clamp(delta, min=0.0)  # density-loss clamp (dfsph.rs:278)
            # particle-deficiency guard (< 9 neighbours, dfsph.rs:260-264)
            delta = torch.where(total_neighbors < 9, 0.0, delta)
            ki = delta * alpha
            s_sum = s_sum + ki
            velocities = velocities - m * self._k_correction(ki, neighborhood, cache)
            avg = f32(float(delta.sum())) * inv_n / rho0
            num += 1
        return velocities, s_sum, num, avg

    # ------------------------------------------------------------ host bounds

    def _densities_alpha(self, positions, neighborhood, boundary: CellGrid):
        """Densities, the pair cache and alpha of freshly built tables
        (dfsph.rs:516-518)."""
        densities = update_densities(positions, neighborhood, boundary.positions,
                                     self.kernel, self.properties.particle_mass,
                                     self.properties.fluid_density)
        cache = self._pair_cache(positions, neighborhood, boundary.positions)
        alpha = self._alpha_from_tables(positions, boundary.positions, neighborhood, cache)
        return densities, cache, alpha

    def init_carry(self, state: ParticleState, boundary: CellGrid) -> DFSPHCarry:
        """Warm-up: tables, densities and alpha of the initial particles
        (dfsph.rs:419-428, clear_cached_data dfsph.rs:406-412)."""
        state, positions, neighborhood = update_neighborhood(
            state, state.positions, boundary, self.grid)
        densities, _, alpha = self._densities_alpha(positions, neighborhood, boundary)
        zeros = torch.zeros_like(densities)
        return DFSPHCarry(
            particles=state._replace(positions=positions, densities=densities),
            alpha=alpha,
            warmstart_kappa=zeros,
            warmstart_stiffness=zeros.clone(),
            neighborhood=neighborhood,
            prev_density_iterations=1,  # dfsph.rs:52
            prev_divergence_iterations=0,  # dfsph.rs:56
            time=TimeState.initial(self.step_config),
        )

    def export_state(self, carry: DFSPHCarry) -> ParticleState:
        """The particles, N rows in cell order (`alive` marks the real ones)."""
        return carry.particles

    # the host loop of the slot solvers: account each step's dt, then step;
    # the Diagnostics aggregate all steps
    simulate = DFSPHSlotSolver.simulate

    # -------------------------------------------------------------------- step

    def step(self, carry: DFSPHCarry, boundary: CellGrid):
        """One simulation step (reference: dfsph.rs:414-525); `carry.time`
        must already be accounted. Returns (carry, Diagnostics)."""
        positions, velocities, densities, alive = carry.particles
        neighborhood = carry.neighborhood
        time_state = carry.time
        dt = time_state.dt
        n_live = f32(int(alive.sum()))
        m = self.properties.particle_mass

        cache = self._pair_cache(positions, neighborhood, boundary.positions)

        # non-pressure forces: gravity + viscosity over the fluid table only
        # (dfsph.rs:437-469)
        dyn = neighborhood.dynamic
        _, r_sq, r = pair.pair_geometry(positions, pair.gather(positions, dyn.idx))
        visc = self.viscosity_model.compute_viscous_acceleration(
            float(dt), r_sq, r, m, pair.gather(densities, dyn.idx),
            pair.gather(velocities, dyn.idx) - velocities[:, None, :])
        gvec = torch.tensor(self.gravity, dtype=REAL, device=positions.device)
        accel = pair.masked_sum(visc, dyn.mask) + gvec[None, :]
        # dead (padding) particles are frozen: no gravity, no advection
        accel = torch.where(alive[:, None], accel, 0.0)

        # CFL with the old-dt velocity estimate (dfsph.rs:472-481), live only
        v_estimate = velocities + accel * float(dt)
        v_est_sq = torch.where(alive, (v_estimate * v_estimate).sum(dim=-1), 0.0)
        max_velocity = f32(float(torch.sqrt(v_est_sq.max())))
        time_state = update_simulation_step(
            self.step_config, time_state, self.properties.particle_radius * 2.0,
            max_velocity)
        dt = time_state.dt

        # v* with the NEW dt (dfsph.rs:484-492), constant-density loop (:496)
        predicted = velocities + accel * float(dt)
        predicted, kappa, density_iters, avg_density_error = self._correct_density_error(
            dt, densities, carry.alpha, predicted, carry.warmstart_kappa,
            carry.prev_density_iterations, neighborhood, cache, n_live)

        # advect (dfsph.rs:499-510), rebuild co-sorting what persists (:512)
        positions = positions + predicted * float(dt)
        (predicted, kappa, stiffness, alive), positions, neighborhood = update_neighborhood(
            (predicted, kappa, carry.warmstart_stiffness, alive), positions, boundary,
            self.grid)
        densities, cache, alpha = self._densities_alpha(positions, neighborhood, boundary)

        # divergence-free loop (dfsph.rs:521); velocities <- v* (:524)
        predicted, stiffness, divergence_iters, avg_divergence = (
            self._correct_divergence_error(
                dt, alpha, predicted, stiffness, carry.prev_divergence_iterations,
                neighborhood, cache, n_live))

        new_carry = DFSPHCarry(
            particles=ParticleState(positions, predicted, densities, alive),
            alpha=alpha,
            warmstart_kappa=kappa,
            warmstart_stiffness=stiffness,
            neighborhood=neighborhood,
            prev_density_iterations=density_iters,
            prev_divergence_iterations=divergence_iters,
            time=time_state,
        )
        diagnostics = Diagnostics(
            dt=dt,
            max_velocity=max_velocity,
            # both tables the step consumed: the carried-in and the rebuilt
            neighbor_drops=max(_drops(carry.neighborhood), _drops(neighborhood)),
            density_iterations=density_iters,
            divergence_iterations=divergence_iters,
            avg_density_error=avg_density_error,
            avg_divergence=avg_divergence,
            migration_drops=0,
        )
        return new_carry, diagnostics


def _drops(neighborhood: Neighborhood) -> int:
    return int(neighborhood.dynamic.num_dropped + neighborhood.static.num_dropped)
