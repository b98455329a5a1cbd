"""DFSPH on the dense slot grid (PyTorch port of yasph2d_tpu/models/
dfsph_dense.py; algorithm: Bender & Koschier, reference
src/sph/solver/dfsph.rs:414-525), with two carries:

- `DFSPHPaddedSolver`, the padded-resident carry: the state stays in the
  (ny, nx, P[, 2]) slot layout between steps (positions, velocities, both
  warm starts), and the rebuild is K4's re-bucket;
- `DFSPHDenseSolver`, the sorted carry (JAX `DFSPHDenseSolver`): the
  particles live in cell-sorted (N, ...) arrays, and every rebuilding step
  sorts them (`sort_by_dense_keys`, stable), builds the slot grid and pads
  the positions and loop state into it; the pressure loops run in the slot
  layout, and their results return to the sorted arrays through
  `slots_to_sorted` (a particle without a slot, dead or beyond a cell's
  occupancy, takes a fallback: a gravity-only prediction, zero warm starts,
  rho0). The loop state that the next step consumes in the same slots
  (v*, kappa, stiffness) also stays padded, as in JAX.

Both share `DFSPHSlotSolver`: the pair forms, the pair context, the pair
passes and both pressure loops, so their arithmetic is one. A step is the
viscosity pass, the CFL
update, the constant-density loop, advection, the neighbourhood rebuild, a new
pair context and the divergence-free loop. Every pair pass runs on a kernel
that reads the carry in place; `DenseGridConfig.use_pallas_slotmajor` picks
which one:

    True   K3 (ops/sm_pair_reduce.py): dfsph_ctx, dfsph_stat (the boundary),
           dfsph_div, dfsph_corr, dfsph_visc, in the JAX slot-major closures'
           operation order; the boundary pass, an XLA pair_reduce in the JAX
           package, in its XLA closure's order
    False  K5 (ops/pallas_pair.py): dfsph_ctx (fluid and boundary), dfsph_div,
           dfsph_corr, dfsph_visc, in the XLA closures' order; on a grid with
           pair_dtype "bfloat16" in K5's bf16 math mode (the JAX XLA route's:
           cell-relative bf16 pair math, f32 sums; the glue stays f32), which
           K3 refuses as JAX does

and the padded carry's rebuild is K4 (ops/sm_rebucket.py) with the payload
[v*(2) | kappa | stiffness] on both (the JAX package's XLA rebucket is
bit-equal to it); the sorted carry's is the sort. The viscosity form is the
model's: dfsph_visc (XSPH) or dfsph_visc_phys (PhysicalViscosityModel) on
either kernel; any other model is refused. The JAX `lax.while_loop`s become host loops that read one
residual back per iteration, with the JAX exit test (a loop may run max + 1
times).

`rebuild_every = k > 1` is the JAX package's opt-in stale steps: `simulate`
runs blocks of one rebuilding step and k - 1 stale ones, which keep the slot
layout (no K4) and refresh the pair context from the advected positions with
the carry's drop count; leftover steps rebuild.

Spatial sharding (parallel/shard_dense.py) overrides the hooks `_halo` (the
neighbour shards' rows -1 and ny, None here) and `_rebucket_row0`: then
every K5 pass and the K4 rebuild take the kernels' halo forms, with the
fluid's rows exchanged once per pair context (kept in `DenseCtx.halo`), the
boundary's once at init (`BoundaryDense.halo`) and the source values' once
per pass; and the reductions over live slots (`_count_live`, `_mean_live`,
the CFL max `_max_vel_from_sq`, `_sum_counts`) run over the shards.

Also here: the static boundary index space (`build_boundary_dense`), the
padded initial layout (`_padded_init`) and `simulate`, which the plane solver
(models/dfsph_plane.py) builds on. Not ported: the sorted solver's cached
and MXU loop gradients (`cache_loop_gradients`, `mxu_loop_gradients`, which
raise), and its sharded form (JAX parallel/shard_dense.py
DFSPHShardMapSolver).
"""

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.cuda_build import PairConsts
from ..ops.dense_grid import (
    DenseGridConfig,
    SlotGrid,
    build_slot_grid,
    cell_keys,
    pad_to_slots,
    require_float32_pairs,
    slots_to_sorted,
    sort_by_dense_keys,
)
from ..ops.pair_reduce import PairForm
from ..ops.pallas_pair import bf16_consts, bf16_form, pallas_pair_reduce, rebase_of
from ..ops.planes import Halo
from ..ops.sm_pair_reduce import sm_pair_reduce
from ..ops.sm_rebucket import sm_rebucket_parts
from ..ops.smoothing_kernels import WendlandQuinticC2
from ..timemanager import StepConfig, TimeState, update_simulation_step
from ..units import INDEX, REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..world import GRAVITY, FluidProperties, ParticleState
from .viscosity import ViscosityModel, kernel_coefficient

f32 = REAL_NP

ALPHA_EPSILON = 1e-6  # dfsph.rs:71


class BoundaryDense(NamedTuple):
    """Static (boundary) index space in dense layout; built on boundary change."""

    pos_pad: torch.Tensor  # (ny, nx, Pb, 2)
    mask: torch.Tensor  # (ny, nx, Pb) bool
    num_dropped: torch.Tensor  # () int32
    # under sharding: the neighbour shards' rows of (pos_pad, mask), (2, nx, Pb[, 2])
    halo: Optional[Halo] = None


def build_boundary_dense(boundary_positions: torch.Tensor, grid: DenseGridConfig,
                         occupancy=None) -> BoundaryDense:
    """Build the static index space. `occupancy=None` sizes the slot axis to the
    boundary's true maximum cell occupancy, rounded up to even."""
    keys = cell_keys(boundary_positions, grid)
    if occupancy is None:
        keys_host = keys.cpu().numpy()
        counts = np.bincount(keys_host) if keys_host.size else np.zeros(1, np.int64)
        occupancy = max(int(counts.max()), 1)
        occupancy += (-occupancy) % 2
    bgrid = dataclasses.replace(grid, occupancy=occupancy)
    keys = cell_keys(boundary_positions, bgrid)
    sorted_keys, order = torch.sort(keys, stable=True)
    slots = build_slot_grid(sorted_keys, bgrid)
    return BoundaryDense(
        pos_pad=pad_to_slots(boundary_positions[order], slots, bgrid),
        mask=slots.slot_mask.reshape(bgrid.ny, bgrid.nx, occupancy),
        num_dropped=slots.num_dropped,
    )


class PaddedInit(NamedTuple):
    """Initial state in the dense (ny, nx, P) slot layout."""

    pos_pad: torch.Tensor  # (ny, nx, P, 2)
    mask: torch.Tensor  # (ny, nx, P) bool
    v_pad: torch.Tensor  # (ny, nx, P, 2)
    kappa_pad: torch.Tensor  # (ny, nx, P) density-loop warm start
    stiff_pad: torch.Tensor  # (ny, nx, P) divergence-loop warm start
    num_dropped: torch.Tensor  # () int32: fluid + boundary cell overflow
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


class DenseCtx(NamedTuple):
    """Per-rebuild pair context of the padded carry (the JAX DenseCtx's padded
    fields): everything that is invariant while positions are frozen."""

    pos_pad: torch.Tensor  # (ny, nx, P, 2)
    mask: torch.Tensor  # (ny, nx, P) bool
    sum_grad_stat: torch.Tensor  # (ny, nx, P, 2): sum of grad W to boundary neighbours
    neighbor_total: torch.Tensor  # (ny, nx, P) f32: fluid + boundary neighbour counts
    densities_pad: torch.Tensor  # (ny, nx, P): clamped density per slot
    alpha_pad: torch.Tensor  # (ny, nx, P): DFSPH alpha per slot
    num_dropped: torch.Tensor  # () int32
    # under sharding: the neighbour shards' rows of (pos_pad, mask), (2, nx, P[, 2])
    halo: Optional[Halo] = None
    # the sorted carry's slot grid (sorted <-> padded conversions); None on
    # the padded-resident carry
    slots: Optional[SlotGrid] = None


class DFSPHPaddedCarry(NamedTuple):
    """Padded-resident solver state: nothing leaves the slot layout between steps."""

    ctx: DenseCtx
    v_pad: torch.Tensor  # (ny, nx, P, 2)
    kappa_pad: torch.Tensor  # (ny, nx, P) density-loop warm start
    stiff_pad: torch.Tensor  # (ny, nx, P) divergence-loop warm start
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


class PaddedForms(NamedTuple):
    """The pair call forms of the padded step on one route (K3 or K5)."""

    ctx: PairForm  # fluid -> fluid ctx sums
    stat: PairForm  # fluid -> boundary ctx sums
    div: PairForm  # velocity divergence
    corr: PairForm  # k-correction
    visc: PairForm  # viscosity (XSPH or physical)


@dataclass(frozen=True)
class DFSPHSlotSolver:
    """What the DFSPH slot-layout solvers share (tolerances as
    dfsph.rs:49-55): the pair forms of the route, the pair context, the pair
    passes, both pressure loops and `simulate`. The subclasses own the
    carry: DFSPHPaddedSolver (padded-resident), DFSPHDenseSolver (sorted) and,
    through the padded one, DFSPHPlaneSolver (planes)."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: DenseGridConfig
    step_config: StepConfig
    max_avg_density_error: float = 0.01 / 100.0
    max_density_iterations: int = 200
    max_divergence_error: float = 0.1 / 100.0
    max_divergence_iterations: int = 400
    gravity: tuple = GRAVITY
    # rebuild the neighbourhood every k-th step only (the JAX field; 1, the
    # default, rebuilds every step as the reference does): `simulate`
    rebuild_every: int = 1

    # K3 takes float32 only (K5 takes bf16 as its math mode); the plane
    # solver's K1 takes bf16 operands
    _bf16_operands = False

    def __post_init__(self):
        if not self._bf16_operands:
            require_float32_pairs(self.grid, type(self).__name__)
        kernel = WendlandQuinticC2(self.properties.smoothing_length)
        object.__setattr__(self, "kernel", kernel)
        assert abs(self.grid.cell_size - self.properties.smoothing_length) < 1e-12
        m = float(self.properties.particle_mass)
        # W(0), the density self-contribution, evaluated in f32
        zero = torch.zeros((), dtype=REAL)
        w0 = float(kernel.evaluate(zero, zero))
        visc_suffix, visc_consts = kernel_coefficient(self.viscosity_model, m)
        object.__setattr__(self, "_w0", w0)
        object.__setattr__(self, "_visc_suffix", visc_suffix)
        object.__setattr__(self, "_consts", PairConsts(
            radius_sq=self.grid.radius_sq,
            w_h_inv=kernel._h_inv, w_norm=kernel._norm,
            w_norm_grad=kernel._norm_grad,
            mass=m, w0=w0, rho0=float(self.properties.fluid_density),
            alpha_eps=ALPHA_EPSILON,
            gx=float(self.gravity[0]), gy=float(self.gravity[1]),
            **visc_consts,
        ))
        slotmajor = self.grid.use_pallas_slotmajor
        object.__setattr__(self, "_reduce",
                           sm_pair_reduce if slotmajor else pallas_pair_reduce)
        forms = self._make_padded_forms(m, slotmajor)
        if not slotmajor and rebase_of(self.grid) is not None:  # K5's bf16 math mode
            object.__setattr__(self, "_consts", bf16_consts(self._consts))
            forms = PaddedForms(*(bf16_form(f, self._consts) for f in forms))
        object.__setattr__(self, "_padded_forms", forms)

    def _make_padded_forms(self, m: float, slotmajor: bool) -> PaddedForms:
        """The pair terms as Python callables (the twins'), op for op the JAX
        closures of models/dfsph_dense.py: the slot-major ones (:284-289,
        :381-386, :431-435) on K3, the XLA ones (:269-276, :401-403, :451-453)
        on K5 and for K3's boundary pass; viscosity is c (v_j - v_i) in both."""
        kernel = self.kernel
        visc_model = self.viscosity_model

        def ctx_sm(dx, dy, r_sq, r, scalars, q, s):
            w = kernel.evaluate(r_sq, r)
            mgc = kernel.gradient_coefficient(r_sq, r) * m
            gx = mgc * dx
            gy = mgc * dy
            return (w, gx, gy, gx * gx + gy * gy, torch.ones_like(r_sq))

        def ctx_xla(dx, dy, r_sq, r, scalars, q, s):
            w = kernel.evaluate(r_sq, r)
            gc = kernel.gradient_coefficient(r_sq, r)
            gx = (gc * dx) * m
            gy = (gc * dy) * m
            return (w, gx, gy, gx * gx + gy * gy, torch.ones_like(r_sq))

        def div_sm(dx, dy, r_sq, r, scalars, q, s):
            gc = kernel.gradient_coefficient(r_sq, r)
            return (((q[0] - s[0]) * dx + (q[1] - s[1]) * dy) * gc,)

        def div_xla(dx, dy, r_sq, r, scalars, q, s):
            gc = kernel.gradient_coefficient(r_sq, r)
            return ((q[0] - s[0]) * (gc * dx) + (q[1] - s[1]) * (gc * dy),)

        def corr_sm(dx, dy, r_sq, r, scalars, q, s):
            kk = (q[0] + s[0]) * kernel.gradient_coefficient(r_sq, r)
            return (kk * dx, kk * dy)

        def corr_xla(dx, dy, r_sq, r, scalars, q, s):
            kk = q[0] + s[0]
            gc = kernel.gradient_coefficient(r_sq, r)
            return (kk * (gc * dx), kk * (gc * dy))

        def visc(dx, dy, r_sq, r, scalars, q, s):
            c = visc_model.viscous_coefficient(scalars[0], r_sq, r, m, s[2])
            return (c * (s[0] - q[0]), c * (s[1] - q[1]))

        visc_form = PairForm("dfsph_visc" + self._visc_suffix, 2, visc)
        if slotmajor:
            return PaddedForms(
                ctx=PairForm("dfsph_ctx", 5, ctx_sm),
                stat=PairForm("dfsph_stat", 5, ctx_xla),
                div=PairForm("dfsph_div", 1, div_sm),
                corr=PairForm("dfsph_corr", 2, corr_sm),
                visc=visc_form,
            )
        ctx = PairForm("dfsph_ctx", 5, ctx_xla)
        return PaddedForms(ctx=ctx, stat=ctx, div=PairForm("dfsph_div", 1, div_xla),
                           corr=PairForm("dfsph_corr", 2, corr_xla), visc=visc_form)

    def _padded_init(self, state: ParticleState, boundary: BoundaryDense) -> PaddedInit:
        """DFSPHPaddedSolver.init_carry's layout (via DFSPHDenseSolver.init_carry):
        cell-sort, slot grid, padded positions/velocities, zero warm starts."""
        g = self.grid
        (positions, velocities), sorted_keys = self._sort(
            (state.positions, state.velocities), state.positions, state.alive
        )
        slots = build_slot_grid(sorted_keys, g)
        zeros = torch.zeros((g.ny, g.nx, g.occupancy), dtype=REAL,
                            device=positions.device)
        return PaddedInit(
            pos_pad=pad_to_slots(positions, slots, g),
            mask=slots.slot_mask.reshape(g.ny, g.nx, g.occupancy),
            v_pad=pad_to_slots(velocities, slots, g),
            kappa_pad=zeros,
            stiff_pad=zeros.clone(),
            num_dropped=(self._sum_counts(slots.num_dropped)
                         + boundary.num_dropped).to(INDEX),
            prev_density_iterations=1,
            prev_divergence_iterations=0,
            time=TimeState.initial(self.step_config),
        )

    # --- single-device reduction hooks; the shard solvers
    # --- (parallel/shard_dense.py) reduce them over the shards

    def _sort(self, tensors, positions, alive):
        """Init-time cell sort of per-particle tensors (sort_by_dense_keys);
        a shard sorts on its band of rows."""
        return sort_by_dense_keys(tensors, positions, self.grid, alive)

    def _sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        """Sum of a per-shard counter (drops) over the shards: the count itself
        on one device."""
        return count

    def _count_live(self, mask: torch.Tensor) -> np.float32:
        """Live-particle count, the residual-average denominator (the reference
        averages over its exact particle count, dfsph.rs:221, 376-377)."""
        return REAL_NP(int(mask.sum()))

    def _rebucket_row0(self) -> int:
        """This shard's first global cell row: 0 on one device."""
        return 0

    def _halo(self, tensors):
        """The neighbour shards' rows -1 and ny of `tensors` as a Halo, under
        spatial sharding; None on one device (the kernels' one-device forms)."""
        return None

    def _max_vel_from_sq(self, v_est_sq) -> np.float32:
        """CFL velocity from the live slots' squared speeds (dead slots 0); the
        one hook of the CFL max that the shard solvers override."""
        return f32(float(torch.sqrt(v_est_sq.max())))

    def _slot_pair(self, form: PairForm, q_pos, q_mask, s_pos, s_mask, s_halo=None,
                   q_vals=(), s_vals=(), scalars=()):
        """One K3 / K5 pass. A source with a halo (its positions' and mask's
        rows from the neighbour shards) takes its values' rows from them too,
        one exchange per pass, and runs K5's halo form. On a bfloat16 grid
        (K5 only) the pass is in K5's bf16 math mode, rebased on this shard's
        global rows."""
        kw = dict(q_vals=q_vals, s_vals=s_vals, scalars=scalars)
        rebase = rebase_of(self.grid, self._rebucket_row0())
        if rebase is not None:
            kw["rebase"] = rebase
        if s_halo is None:
            return self._reduce(form, q_pos, q_mask, s_pos, s_mask, self._consts, **kw)
        rows = self._halo(s_vals).planes if s_vals else ()
        return pallas_pair_reduce(form, q_pos, q_mask, s_pos, s_mask, self._consts,
                                  halo=s_halo._replace(planes=s_halo.planes + tuple(rows)),
                                  **kw)

    def simulate(self, carry, boundary, num_steps: int):
        """Run `num_steps` steps; the returned Diagnostics aggregates all of them
        (Diagnostics.accumulate). Each step's dt is accounted before it runs.
        With `rebuild_every` = k > 1 the steps run in blocks of one rebuilding
        step and k - 1 stale ones; the num_steps % k leftover steps rebuild
        (JAX dfsph_dense.py simulate)."""
        k = max(int(getattr(self, "rebuild_every", 1)), 1)
        blocked = num_steps - num_steps % k
        agg = Diagnostics.zeros()
        for i in range(num_steps):
            carry = carry._replace(time=carry.time.account_step())
            if i < blocked and i % k:
                carry, diag = self.step(carry, boundary, rebuild=False)
            else:
                carry, diag = self.step(carry, boundary)
            agg = agg.accumulate(diag)
        return carry, agg

    # ------------------------------------------------------------ pair context

    def _ctx_from_padded(self, pos_pad, mask, boundary: BoundaryDense,
                         dropped) -> DenseCtx:
        """The fluid and boundary ctx passes and their assembly
        (dfsph_dense.py:261-346): density with the self-term and the rho0
        clamp, alpha, the boundary gradient sums and the neighbour totals.
        Under sharding the fluid's rows are exchanged here, once per context."""
        f = self._padded_forms
        halo = self._halo((pos_pad, mask))
        dyn = self._slot_pair(f.ctx, pos_pad, mask, pos_pad, mask, halo)
        stat = self._slot_pair(f.stat, pos_pad, mask, boundary.pos_pad, boundary.mask,
                               boundary.halo)
        m = float(self.properties.particle_mass)
        dens = torch.clamp(m * ((self._w0 + dyn[..., 0]) + stat[..., 0]),
                           min=self.properties.fluid_density)
        vx = dyn[..., 1] + stat[..., 1]
        vy = dyn[..., 2] + stat[..., 2]
        denom = ((vx * vx + vy * vy) + dyn[..., 3]) + stat[..., 3]
        # a tensor divisor: a Python one would become a reciprocal multiply on
        # CUDA, one ulp away from the JAX package's true division
        m_t = torch.tensor(m, dtype=REAL, device=pos_pad.device)
        return DenseCtx(
            pos_pad=pos_pad,
            mask=mask,
            sum_grad_stat=stat[..., 1:3] / m_t,
            neighbor_total=dyn[..., 4] + stat[..., 4],
            densities_pad=dens,
            alpha_pad=1.0 / torch.clamp(denom, min=ALPHA_EPSILON),
            num_dropped=dropped,
            halo=halo,
        )

    # --------------------------------------------------------------- pair ops

    def _velocity_divergence(self, ctx: DenseCtx, v_pad):
        """sum_dyn (v_i - v_j).grad + v_i.sum_grad_stat (dfsph.rs:99-126, 249-280)."""
        dyn = self._slot_pair(self._padded_forms.div, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                              ctx.mask, ctx.halo, q_vals=(v_pad,), s_vals=(v_pad,))
        sgs = ctx.sum_grad_stat
        return dyn[..., 0] + (v_pad[..., 0] * sgs[..., 0] + v_pad[..., 1] * sgs[..., 1])

    def _k_correction(self, ctx: DenseCtx, k_pad):
        """sum_dyn (k_i + k_j) grad + k_i sum_grad_stat (dfsph.rs:128-161)."""
        dyn = self._slot_pair(self._padded_forms.corr, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                              ctx.mask, ctx.halo, q_vals=(k_pad,), s_vals=(k_pad,))
        return dyn + k_pad[..., None] * ctx.sum_grad_stat

    def _viscosity_pass(self, ctx: DenseCtx, v_pad, rho_pad, dt):
        """Viscous acceleration over fluid neighbours, (ny, nx, P, 2)."""
        return self._slot_pair(self._padded_forms.visc, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                               ctx.mask, ctx.halo, q_vals=(v_pad,), s_vals=(v_pad, rho_pad),
                               scalars=(float(dt),))

    def _mean_live(self, value_pad, ctx: DenseCtx, n_particles) -> np.float32:
        total = torch.where(ctx.mask, value_pad, 0.0).sum()
        return f32(float(total)) / f32(n_particles)

    def _max_velocity(self, vstar_pad, mask) -> np.float32:
        """CFL velocity estimate over live slots (dfsph.rs:474-477)."""
        return self._max_vel_from_sq(torch.where(mask, (vstar_pad * vstar_pad).sum(dim=-1),
                                                 0.0))

    # ---------------------------------------------------------- pressure loops

    def _correct_density_error(self, dt, dens_pad, alpha_pad, v_pad, kappa_pad,
                               prev_iterations, ctx: DenseCtx, n_particles):
        """Constant-density loop (dfsph_dense.py:529-561); returns
        (v, kappa sum, iterations, last average density error)."""
        rho0 = f32(self.properties.fluid_density)
        m = f32(self.properties.particle_mass)
        scale = float((f32(1.0) / f32(dt)) * m)
        tol = f32(self.max_avg_density_error)
        if prev_iterations > 1:  # warm start
            k = 0.5 * torch.clamp(kappa_pad, min=float(f32(-0.5) * rho0 * rho0))
            v_pad = v_pad - scale * self._k_correction(ctx, k)
        k_sum = torch.zeros_like(kappa_pad)
        num, avg = 0, f32(np.inf)
        while num == 0 or (
            (avg / rho0) * dt >= tol and num <= self.max_density_iterations
        ):
            delta = self._velocity_divergence(ctx, v_pad)
            err = torch.clamp(dens_pad + delta * float(m) * float(dt),
                              min=float(rho0)) - float(rho0)
            ki = err * alpha_pad
            k_sum = k_sum + ki
            v_pad = v_pad - scale * self._k_correction(ctx, ki)
            avg = self._mean_live(err, ctx, n_particles)
            num += 1
        return v_pad, k_sum, num, avg

    def _correct_divergence_error(self, dt, alpha_pad, v_pad, stiff_pad,
                                  prev_iterations, ctx: DenseCtx, n_particles):
        """Divergence-free loop (dfsph_dense.py:565-598)."""
        rho0 = f32(self.properties.fluid_density)
        m = float(f32(self.properties.particle_mass))
        tol = f32(self.max_divergence_error)
        if prev_iterations > 1:  # warm start
            s = 0.5 * torch.clamp(stiff_pad, min=float(f32(-0.5) * rho0 * rho0))
            v_pad = v_pad - m * self._k_correction(ctx, s)
        s_sum = torch.zeros_like(stiff_pad)
        num, avg = 0, f32(np.inf)
        while num == 0 or (avg * dt >= tol and num <= self.max_divergence_iterations):
            delta = torch.clamp(self._velocity_divergence(ctx, v_pad) * m, min=0.0)
            # particle-deficiency guard (<9 total neighbours, dfsph.rs:260-264)
            delta = torch.where(ctx.neighbor_total < 9, 0.0, delta)
            ki = delta * alpha_pad
            s_sum = s_sum + ki
            v_pad = v_pad - m * self._k_correction(ctx, ki)
            avg = self._mean_live(delta, ctx, n_particles) / rho0
            num += 1
        return v_pad, s_sum, num, avg


@dataclass(frozen=True)
class DFSPHPaddedSolver(DFSPHSlotSolver):
    """DFSPH with the padded-resident carry: the state never leaves the slot
    layout, and the rebuild is K4's re-bucket."""

    def init_carry(self, state: ParticleState, boundary: BoundaryDense
                   ) -> DFSPHPaddedCarry:
        base = self._padded_init(state, boundary)
        return DFSPHPaddedCarry(
            ctx=self._ctx_from_padded(base.pos_pad, base.mask, boundary,
                                      base.num_dropped),
            v_pad=base.v_pad,
            kappa_pad=base.kappa_pad,
            stiff_pad=base.stiff_pad,
            prev_density_iterations=base.prev_density_iterations,
            prev_divergence_iterations=base.prev_divergence_iterations,
            time=base.time,
        )

    def export_state(self, carry: DFSPHPaddedCarry) -> ParticleState:
        """Flat slot-order view: N = ny*nx*P rows, `alive` = slot mask; dead
        rows hold zero velocity and rho0."""
        mask = carry.ctx.mask.reshape(-1)
        return ParticleState(
            positions=carry.ctx.pos_pad.reshape(-1, 2),
            velocities=torch.where(mask[:, None], carry.v_pad.reshape(-1, 2), 0.0),
            densities=torch.where(mask, carry.ctx.densities_pad.reshape(-1),
                                  self.properties.fluid_density),
            alive=mask,
        )

    # -------------------------------------------------------------------- step

    def step(self, carry: DFSPHPaddedCarry, boundary: BoundaryDense,
             rebuild: bool = True):
        """One simulation step in the JAX step's order (dfsph.rs:414-525). A
        stale step (`rebuild` False) keeps the slot layout and refreshes the
        pair context from the advected positions, its drop count the carry's."""
        ctx = carry.ctx
        time_state = carry.time
        dt = time_state.dt
        n = self._count_live(ctx.mask)
        v_pad = carry.v_pad
        rho_pad = ctx.densities_pad

        gvec = torch.tensor(self.gravity, dtype=REAL, device=v_pad.device)
        accel = self._viscosity_pass(ctx, v_pad, rho_pad, dt) + gvec

        # CFL with the old-dt estimate (dfsph.rs:472-481)
        vstar = v_pad + accel * float(dt)
        max_velocity = self._max_velocity(vstar, ctx.mask)
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )
        dt = time_state.dt

        # predict v* with the new dt, constant-density loop (dfsph.rs:484-496)
        pred = v_pad + accel * float(dt)
        pred, kappa, density_iters, avg_density_error = self._correct_density_error(
            dt, rho_pad, ctx.alpha_pad, pred, carry.kappa_pad,
            carry.prev_density_iterations, ctx, n,
        )

        # advect + re-bucket (dfsph.rs:499-512): [v*(2) | kappa | stiffness]
        pos = ctx.pos_pad + pred * float(dt)
        if rebuild:
            payload = (pred, kappa, carry.stiff_pad)
            pos, mask, (pred, kappa, stiff), drops = sm_rebucket_parts(
                pos, ctx.mask, payload, self.grid, halo=self._halo((ctx.mask, pos, *payload)))
            ctx = self._ctx_from_padded(pos, mask, boundary,
                                        self._sum_counts(drops) + boundary.num_dropped)
        else:
            stiff = carry.stiff_pad
            ctx = self._ctx_from_padded(pos, ctx.mask, boundary, ctx.num_dropped)

        # divergence-free loop (dfsph.rs:521)
        pred, stiff, divergence_iters, avg_divergence = self._correct_divergence_error(
            dt, ctx.alpha_pad, pred, stiff, carry.prev_divergence_iterations, ctx, n,
        )

        new_carry = DFSPHPaddedCarry(
            ctx=ctx,
            v_pad=pred,
            kappa_pad=kappa,
            stiff_pad=stiff,
            prev_density_iterations=density_iters,
            prev_divergence_iterations=divergence_iters,
            time=time_state,
        )
        diagnostics = Diagnostics(
            dt=dt,
            max_velocity=max_velocity,
            neighbor_drops=int(ctx.num_dropped),
            density_iterations=density_iters,
            divergence_iterations=divergence_iters,
            avg_density_error=avg_density_error,
            avg_divergence=avg_divergence,
            migration_drops=0,
        )
        return new_carry, diagnostics


# ----------------------------------------------------------------- sorted carry


class DFSPHDenseCarry(NamedTuple):
    """The sorted carry: particles in cell-sorted order, and the loop state
    that the next step consumes in the same slot layout (`ctx.slots`) kept
    padded: v_pad is the velocities, kappa_pad and stiff_pad the warm starts."""

    particles: ParticleState  # sorted by cell key
    alpha: torch.Tensor  # (N,) sorted
    warmstart_stiffness: torch.Tensor  # (N,) sorted (the rebuild's input)
    v_pad: torch.Tensor  # (ny, nx, P, 2) in ctx.slots
    kappa_pad: torch.Tensor  # (ny, nx, P) in ctx.slots
    stiff_pad: torch.Tensor  # (ny, nx, P) in ctx.slots (a stale step's input)
    ctx: DenseCtx  # with its slots
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


@dataclass(frozen=True)
class DFSPHDenseSolver(DFSPHSlotSolver):
    """DFSPH with the sorted carry (module docstring): a per-step sort and
    slot build instead of K4, the pair passes on K3 or K5."""

    # the JAX loop-gradient variants (a cached (ny, nx, P, 9P, 2) gradient
    # tensor; its bf16 MXU contraction): not ported, they raise
    cache_loop_gradients: bool = False
    mxu_loop_gradients: bool = False

    def __post_init__(self):
        for flag in ("cache_loop_gradients", "mxu_loop_gradients"):
            if getattr(self, flag):
                raise ValueError(
                    f"DFSPHDenseSolver: {flag} is not ported (ROADMAP Queue 1, "
                    "'The loop-gradient variants of the sorted solver')")
        super().__post_init__()

    def _slot_ctx(self, pos_pad, slots: SlotGrid, boundary: BoundaryDense,
                  dropped=None) -> DenseCtx:
        """The pair context of padded positions in `slots` (JAX
        `_ctx_from_slots`); its drops are the slot grid's and the boundary's
        unless `dropped` is given (a stale step keeps the carry's)."""
        g = self.grid
        if dropped is None:
            dropped = self._sum_counts(slots.num_dropped) + boundary.num_dropped
        mask = slots.slot_mask.reshape(g.ny, g.nx, g.occupancy)
        return self._ctx_from_padded(pos_pad, mask, boundary, dropped)._replace(slots=slots)

    def init_carry(self, state: ParticleState, boundary: BoundaryDense) -> DFSPHDenseCarry:
        g = self.grid
        sorted_state, sorted_keys = self._sort(tuple(state), state.positions, state.alive)
        state = ParticleState(*sorted_state)
        slots = build_slot_grid(sorted_keys, g)
        ctx = self._slot_ctx(pad_to_slots(state.positions, slots, g), slots, boundary)
        zeros = torch.zeros(ctx.mask.shape, dtype=REAL, device=ctx.mask.device)
        return DFSPHDenseCarry(
            particles=state._replace(densities=slots_to_sorted(
                ctx.densities_pad, slots, g, self.properties.fluid_density)),
            alpha=slots_to_sorted(ctx.alpha_pad, slots, g),
            warmstart_stiffness=torch.zeros_like(state.densities),
            v_pad=pad_to_slots(state.velocities, slots, g),
            kappa_pad=zeros,
            stiff_pad=zeros.clone(),
            ctx=ctx,
            prev_density_iterations=1,
            prev_divergence_iterations=0,
            time=TimeState.initial(self.step_config),
        )

    def export_state(self, carry: DFSPHDenseCarry) -> ParticleState:
        """The particles, N rows in cell order (`alive` marks the real ones)."""
        return carry.particles

    def step(self, carry: DFSPHDenseCarry, boundary: BoundaryDense, rebuild: bool = True):
        """One simulation step in the JAX sorted step's order (dfsph.rs:414-525).
        A stale step (`rebuild` False) keeps the sort order and the slots and
        refreshes the pair context from the advected positions."""
        g = self.grid
        positions, velocities, _, alive = carry.particles
        ctx = carry.ctx
        time_state = carry.time
        dt = time_state.dt
        n = self._count_live(alive)
        rho_pad = ctx.densities_pad

        gvec = torch.tensor(self.gravity, dtype=REAL, device=positions.device)
        accel_pad = self._viscosity_pass(ctx, carry.v_pad, rho_pad, dt) + gvec

        # CFL with the old-dt estimate (dfsph.rs:472-481)
        max_velocity = self._max_velocity(carry.v_pad + accel_pad * float(dt), ctx.mask)
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )
        dt = time_state.dt

        # v* with the new dt, constant-density loop (dfsph.rs:484-496)
        pred_pad = carry.v_pad + accel_pad * float(dt)
        pred_pad, kappa_pad, density_iters, avg_density_error = self._correct_density_error(
            dt, rho_pad, ctx.alpha_pad, pred_pad, carry.kappa_pad,
            carry.prev_density_iterations, ctx, n,
        )
        # one unpad of (v*, kappa): a particle without a slot falls back to a
        # gravity-only prediction and zero kappa; dead particles stay frozen
        fallback = torch.where(alive[:, None], velocities + gvec * float(dt), velocities)
        pk = slots_to_sorted(torch.cat([pred_pad, kappa_pad[..., None]], dim=-1), ctx.slots,
                             g, torch.cat([fallback, torch.zeros_like(fallback[:, :1])], 1))
        predicted = pk[:, :2]

        # advect, re-sort, new slots and pair context (dfsph.rs:499-512)
        positions = positions + predicted * float(dt)
        if rebuild:
            # everything that crosses the rebuild in one matrix:
            # [pos(2) | v*(2) | kappa | stiffness | alive]
            packed = torch.cat([positions, predicted, pk[:, 2:3],
                                carry.warmstart_stiffness[:, None],
                                alive.to(REAL)[:, None]], dim=1)
            (packed,), sorted_keys = self._sort((packed,), packed[:, :2], alive)
            alive = packed[:, 6] > 0.5
            positions = packed[:, :2]
            predicted = packed[:, 2:4]
            slots = build_slot_grid(sorted_keys, g)
            pad6 = pad_to_slots(packed[:, :6], slots, g)
            pred_pad = pad6[..., 2:4].contiguous()
            kappa_pad = pad6[..., 4].contiguous()  # next step's warm start, new slots
            stiff_pad = pad6[..., 5].contiguous()
            ctx = self._slot_ctx(pad6[..., :2].contiguous(), slots, boundary)
        else:
            stiff_pad = carry.stiff_pad
            ctx = self._slot_ctx(ctx.pos_pad + pred_pad * float(dt), ctx.slots, boundary,
                                 ctx.num_dropped)

        # divergence-free loop (dfsph.rs:521)
        pred_pad, stiff_pad, divergence_iters, avg_divergence = self._correct_divergence_error(
            dt, ctx.alpha_pad, pred_pad, stiff_pad, carry.prev_divergence_iterations, ctx, n,
        )
        # one unpad of everything that leaves the slots:
        # [v*(2) | stiffness | density | alpha]
        zeros1 = torch.zeros_like(predicted[:, :1])
        out = slots_to_sorted(
            torch.cat([pred_pad, stiff_pad[..., None], ctx.densities_pad[..., None],
                       ctx.alpha_pad[..., None]], dim=-1), ctx.slots, g,
            torch.cat([predicted, zeros1, torch.full_like(zeros1, self.properties.fluid_density),
                       zeros1], 1))

        new_carry = DFSPHDenseCarry(
            particles=ParticleState(positions, out[:, :2], out[:, 3], alive),
            alpha=out[:, 4],
            warmstart_stiffness=out[:, 2],
            v_pad=pred_pad,  # the next step consumes it in these slots
            kappa_pad=kappa_pad,
            stiff_pad=stiff_pad,
            ctx=ctx,
            prev_density_iterations=density_iters,
            prev_divergence_iterations=divergence_iters,
            time=time_state,
        )
        diagnostics = Diagnostics(
            dt=dt,
            max_velocity=max_velocity,
            # both grids the step consumed: the carried-in and the rebuilt
            neighbor_drops=max(int(carry.ctx.num_dropped), int(ctx.num_dropped)),
            density_iterations=density_iters,
            divergence_iterations=divergence_iters,
            avg_density_error=avg_density_error,
            avg_divergence=avg_divergence,
            migration_drops=0,
        )
        return new_carry, diagnostics
