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

Both share `DFSPHSlotSolver` (on the slot solvers' base,
models/slot_solver.py): the pair forms, the pair context, the pair passes
and both pressure loops, so their arithmetic is one. A step is the viscosity
pass, the CFL update, the constant-density loop, advection, the
neighbourhood rebuild, a new pair context and the divergence-free loop.
Every pair pass runs on the route's kernel (`pair_route`), reading the carry
in place: K3 (ops/sm_pair_reduce.py; dfsph_ctx, dfsph_stat for the
boundary, dfsph_div, dfsph_corr, dfsph_visc, in the JAX slot-major
closures' order, the boundary pass in its XLA closure's) or K5
(ops/pallas_pair.py; dfsph_ctx for the fluid and the boundary, dfsph_div,
dfsph_corr, dfsph_visc in the XLA closures' order, in K5's bf16 math mode on
a bfloat16 grid, the glue staying f32).

The glue of a pressure-loop iteration between its div and corr passes is
two kernels on either route (ops/pressure_glue.py: the error, k_i, k_sum and
the residual's sum, then the velocity update, in place on the loop's own
tensors), their twins on CPU tensors; the loop-gradient variants keep torch
operations, and the plane solver (models/dfsph_plane.py) runs the same loops
through K1's epilogues or torch.

Where those kernels run on one CUDA device (`_device_exit`), the loops'
exit test runs on the device: the error kernel tests each iteration's total
and gates the iterations the host enqueued ahead (K5's or K3's div and corr
passes, both glue kernels), and the host reads the loop's state back once a
chunk of iterations (`_pressure_loop`). Everywhere else (sharding, the
plane solver, the loop-gradient variants, CPU tensors) the host reads each
iteration's total back and tests it.

The padded carry's rebuild is K4 (ops/sm_rebucket.py) with the payload
[v*(2) | kappa | stiffness] on both (the JAX package's XLA rebucket is
bit-equal to it); the sorted carry's is the sort. The viscosity form is the
model's: dfsph_visc (XSPH) or dfsph_visc_phys (PhysicalViscosityModel) on
either kernel; any other model is refused. The JAX `lax.while_loop`s become
host loops with the JAX exit test (a loop may run max + 1 times), tested on
the device or on the host as above.

`rebuild_every = k > 1` is the JAX package's opt-in stale steps: `simulate`
runs blocks of one rebuilding step and k - 1 stale ones, which keep the slot
layout (no K4) and refresh the pair context from the advected positions with
the carry's drop count; leftover steps rebuild.

Under spatial sharding (parallel/shard_dense.py) the hooks of
models/slot_solver.py exchange rows and reduce over the shards: every K5
pass and the K4 rebuild take the kernels' halo forms, the fluid's rows
exchanged once per pair context (`DenseCtx.halo`), the boundary's once at
init (`BoundaryDense.halo`), the source values' once per pass; the live
count, the CFL max and the loops' residual sums (`_mean_of_sum`) are global.

The sorted step's rebuild calls the hook `_migrate` before its sort: one
device has nothing to move (`(tree, 0)`); the sharded sorted solver
(parallel/shard_dense.DFSPHShardMapSolver) sends the particles that left
its rows to the neighbour shards in bounded buffers and reports the
particles it could not move in `Diagnostics.migration_drops`. The padded
step's migration is structural (K4's halo rows), so it reports 0.

The JAX loop-gradient variants run on both carries, as in JAX, where both
solvers inherit them: `cache_loop_gradients` keeps the f32 kernel gradient
of every fluid pair, `pair_map`'s (ny, nx, P, 9P, 2), in the pair context
(`DenseCtx.grad_dyn`) and runs the pressure loops' divergence and
k-correction passes as `cached_pair_reduce` sums over it;
`mxu_loop_gradients` keeps it rounded to bf16 with the f32 row sums
(`DenseCtx.sum_grad_dyn`, the ctx pass's) and runs those passes as batched
contractions over the (9P, 2) candidate axes, bf16 operands summed in f32
(JAX: `lax.dot_general` with an f32 result on the MXU; here a torch matmul
of the bf16 values as f32, TF32 off, whose products are exact). The
viscosity pass stays K5's. They are plain tensor passes, as in JAX, where
they are XLA outside any Pallas kernel. Refused, each with a ValueError:
the cache with bf16 pair math, the two together, either on the K3 route,
and either under sharding (JAX refuses the MXU form there; its cache would
zero the neighbours' rows across a seam, a fault the port does not copy).

Also here: the static boundary index space (`build_boundary_dense`) and the
padded initial layout (`_padded_init`), which the plane solver builds on.
"""

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import pressure_glue
from ..ops.cuda_build import PairConsts
from ..ops.dense_grid import (
    DenseGridConfig,
    SlotGrid,
    build_slot_grid,
    cached_pair_reduce,
    cell_keys,
    neighbor_windows,
    pad_to_slots,
    pair_map,
    slots_to_sorted,
)
from ..ops.pair_reduce import PairForm
from ..ops.planes import Halo
from ..ops.sm_rebucket import sm_rebucket_parts
from ..ops.smoothing_kernels import WendlandQuinticC2
from ..timemanager import TimeState, update_simulation_step
from ..units import INDEX, REAL, REAL_NP
from ..utils.diagnostics import Diagnostics
from ..utils.profiling import read_back, scope
from ..world import GRAVITY, ParticleState
from .slot_solver import SlotSolver

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
    # (ny, nx, P, 9P, 2) masked kernel gradients of the fluid pairs, for the
    # pressure loops: f32 under cache_loop_gradients, bf16 under
    # mxu_loop_gradients, else None
    grad_dyn: Optional[torch.Tensor] = None
    # (ny, nx, P, 2) f32 row sums of grad_dyn (mxu_loop_gradients only): the
    # v_i and k_i terms of the loop passes
    sum_grad_dyn: Optional[torch.Tensor] = None


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
class DFSPHSlotSolver(SlotSolver):
    """What the DFSPH slot-layout solvers share (tolerances as
    dfsph.rs:49-55): the pair forms, the pair context, the pair passes and
    both pressure loops. The subclasses own the carry: DFSPHPaddedSolver
    (padded-resident), DFSPHDenseSolver (sorted) and, through the padded
    one, DFSPHPlaneSolver (planes)."""

    max_avg_density_error: float = 0.01 / 100.0
    max_density_iterations: int = 200
    max_divergence_error: float = 0.1 / 100.0
    max_divergence_iterations: int = 400
    gravity: tuple = GRAVITY
    # rebuild the neighbourhood every k-th step only (the JAX field; 1, the
    # default, rebuilds every step as the reference does): `simulate`
    rebuild_every: int = 1
    # the JAX loop-gradient variants (module docstring): the pressure loops'
    # divergence and k-correction passes over a cached gradient tensor (f32),
    # or as bf16 contractions summed in f32
    cache_loop_gradients: bool = False
    mxu_loop_gradients: bool = False

    def __post_init__(self):
        self._check_loop_gradients()
        kernel = WendlandQuinticC2(self.properties.smoothing_length)
        object.__setattr__(self, "kernel", kernel)
        # W(0), the density self-contribution, evaluated in f32
        zero = torch.zeros((), dtype=REAL)
        object.__setattr__(self, "_w0", float(kernel.evaluate(zero, zero)))
        super().__post_init__()
        # the pressure loops' glue kernels skip quads of dead slots where
        # K5's +0.0 at dead query slots make them identities: a dead slot's
        # density m (W(0) + 0 + 0) clamps to rho0 (ops/pressure_glue.py)
        m, rho0 = f32(self.properties.particle_mass), f32(self.properties.fluid_density)
        object.__setattr__(self, "_dead_zero",
                           self._route.dead_zero and m * f32(self._w0) <= rho0)

    def _check_loop_gradients(self):
        """The JAX asserts on the loop-gradient flags
        (models/dfsph_dense.py:186-205), as ValueErrors."""
        name = type(self).__name__
        if self.cache_loop_gradients and self.grid.pair_dtype != "float32":
            raise ValueError(f"{name}: cache_loop_gradients caches f32 gradients; bfloat16 "
                             "pair math is not implemented with it")
        if self.cache_loop_gradients and self.mxu_loop_gradients:
            raise ValueError(f"{name}: mxu_loop_gradients excludes cache_loop_gradients")
        if self.grid.use_pallas_slotmajor and (self.cache_loop_gradients
                                               or self.mxu_loop_gradients):
            raise ValueError(f"{name}: the slot-major route (use_pallas_slotmajor) excludes "
                             "cache_loop_gradients and mxu_loop_gradients")

    def _make_consts(self, m: float, visc_consts: dict) -> PairConsts:
        kernel = self.kernel
        return PairConsts(
            radius_sq=self.grid.radius_sq,
            w_h_inv=kernel._h_inv, w_norm=kernel._norm, w_norm_grad=kernel._norm_grad,
            mass=m, w0=self._w0, rho0=float(self.properties.fluid_density),
            alpha_eps=ALPHA_EPSILON,
            gx=float(self.gravity[0]), gy=float(self.gravity[1]),
            **visc_consts,
        )

    def _make_forms(self, m: float, route) -> PaddedForms:
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
        if route.slot_major:
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

    # ------------------------------------------------------------ pair context

    def _ctx_from_padded(self, pos_pad, mask, boundary: BoundaryDense,
                         dropped) -> DenseCtx:
        """The fluid and boundary ctx passes and their assembly
        (dfsph_dense.py:261-346): density with the self-term and the rho0
        clamp, alpha, the boundary gradient sums and the neighbour totals.
        Under sharding the fluid's rows are exchanged here, once per context."""
        f = self._forms
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
        grad_dyn = sum_grad_dyn = None
        if self.cache_loop_gradients or self.mxu_loop_gradients:
            def gradient(ri_to_rj, r_sq, r):
                grad = self.kernel.gradient(ri_to_rj, r_sq, r)
                return grad.to(torch.bfloat16) if self.mxu_loop_gradients else grad

            grad_dyn = pair_map(gradient, pos_pad, mask, pos_pad, mask, self.grid)
            if self.mxu_loop_gradients:
                # the exact f32 row sums: the ctx pass's m * sum grad
                sum_grad_dyn = dyn[..., 1:3] / m_t
        return DenseCtx(
            pos_pad=pos_pad,
            mask=mask,
            sum_grad_stat=stat[..., 1:3] / m_t,
            neighbor_total=dyn[..., 4] + stat[..., 4],
            densities_pad=dens,
            alpha_pad=1.0 / torch.clamp(denom, min=ALPHA_EPSILON),
            num_dropped=dropped,
            halo=halo,
            grad_dyn=grad_dyn,
            sum_grad_dyn=sum_grad_dyn,
        )

    # --------------------------------------------------------------- pair ops

    def _div_pass(self, ctx: DenseCtx, v_pad):
        """The div pass's (ny, nx, P) sums sum_dyn (v_i - v_j).grad."""
        return self._slot_pair(self._forms.div, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                               ctx.mask, ctx.halo, q_vals=(v_pad,), s_vals=(v_pad,))[..., 0]

    def _corr_pass(self, ctx: DenseCtx, k_pad):
        """The corr pass's (ny, nx, P, 2) sums sum_dyn (k_i + k_j) grad."""
        return self._slot_pair(self._forms.corr, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                               ctx.mask, ctx.halo, q_vals=(k_pad,), s_vals=(k_pad,))

    def _velocity_divergence(self, ctx: DenseCtx, v_pad):
        """sum_dyn (v_i - v_j).grad + v_i.sum_grad_stat (dfsph.rs:99-126, 249-280)."""
        sgs = ctx.sum_grad_stat
        if self.mxu_loop_gradients:
            # sum_j (v_i - v_j).grad = v_i . sum_j grad - sum_j v_j . grad, the
            # second term one contraction over the (9P, 2) candidate axes
            vwin = neighbor_windows(v_pad).to(torch.bfloat16)
            with _exact_f32_matmul():
                term2 = torch.einsum("yxpkc,yxkc->yxp", ctx.grad_dyn.float(), vwin.float())
            sgd = ctx.sum_grad_dyn
            dyn = (v_pad[..., 0] * sgd[..., 0] + v_pad[..., 1] * sgd[..., 1]) - term2
        elif ctx.grad_dyn is not None:
            dyn = cached_pair_reduce(lambda grads, v_i, v_j: ((v_i - v_j) * grads).sum(dim=-1),
                                     ctx.grad_dyn, source_values=(v_pad,),
                                     query_values=(v_pad,))
        else:
            dyn = self._div_pass(ctx, v_pad)
        return dyn + (v_pad[..., 0] * sgs[..., 0] + v_pad[..., 1] * sgs[..., 1])

    def _k_correction(self, ctx: DenseCtx, k_pad):
        """sum_dyn (k_i + k_j) grad + k_i sum_grad_stat (dfsph.rs:128-161)."""
        if self.mxu_loop_gradients:
            # sum_j (k_i + k_j) grad = k_i sum_j grad + sum_j k_j grad
            kwin = neighbor_windows(k_pad).to(torch.bfloat16)
            with _exact_f32_matmul():
                term2 = torch.einsum("yxpkc,yxk->yxpc", ctx.grad_dyn.float(), kwin.float())
            return k_pad[..., None] * (ctx.sum_grad_dyn + ctx.sum_grad_stat) + term2
        if ctx.grad_dyn is not None:
            dyn = cached_pair_reduce(lambda grads, k_i, k_j: (k_i + k_j)[..., None] * grads,
                                     ctx.grad_dyn, source_values=(k_pad,),
                                     query_values=(k_pad,))
        else:
            dyn = self._corr_pass(ctx, k_pad)
        return dyn + k_pad[..., None] * ctx.sum_grad_stat

    def _viscosity_pass(self, ctx: DenseCtx, v_pad, rho_pad, dt):
        """Viscous acceleration over fluid neighbours, (ny, nx, P, 2)."""
        return self._slot_pair(self._forms.visc, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                               ctx.mask, ctx.halo, q_vals=(v_pad,), s_vals=(v_pad, rho_pad),
                               scalars=(float(dt),))

    def _mean_of_sum(self, total, n_particles) -> np.float32:
        """A residual's average over the live particles from its 0-d sum over
        this device's live slots (`_sum_counts` sums it over the shards)."""
        return f32(read_back("mean_residual", self._sum_counts(total))) / f32(n_particles)

    def _max_velocity(self, vstar_pad, mask) -> np.float32:
        """CFL velocity estimate over live slots (dfsph.rs:474-477)."""
        return self._max_vel_from_sq(torch.where(mask, (vstar_pad * vstar_pad).sum(dim=-1),
                                                 0.0))

    # ---------------------------------------------------------- pressure loops

    @staticmethod
    def _slot_glue(ctx) -> bool:
        """Whether the pressure loops' glue runs through ops/pressure_glue.py's
        kernels (its twins on CPU tensors): on K3's and K5's passes; the
        loop-gradient variants keep their torch glue."""
        return ctx.grad_dyn is None

    def _device_exit(self, ctx) -> bool:
        """Whether the pressure loops test their exit on the device: their
        glue is ops/pressure_glue.py's kernels on a CUDA device, and a
        residual's total is this device's own (`_local_sums`)."""
        return self._slot_glue(ctx) and self._local_sums() and ctx.mask.device.type == "cuda"

    def _loop_args(self, dt, density: bool) -> tuple:
        """(m, dt, rho0, density): the error kernel's arguments in float32."""
        return (float(f32(self.properties.particle_mass)), float(dt),
                float(f32(self.properties.fluid_density)), density)

    def _loop_error(self, ctx, v_pad, rho_or_count, alpha_pad, k_sum, work, dt,
                    density: bool):
        """One iteration's error of the velocity divergence of v (the
        density loop's with `density`, `rho_or_count` the densities; else the
        divergence loop's, the neighbour totals) -> (k_i, k_sum + k_i, the
        error's 0-d sum over the live slots). `work`: the loop's buffer
        (`pressure_glue.loop_work`)."""
        args = self._loop_args(dt, density)
        if self._slot_glue(ctx):
            return pressure_glue.slot_pressure_err(
                self._div_pass(ctx, v_pad), v_pad, ctx.sum_grad_stat, rho_or_count, alpha_pad,
                k_sum, work, ctx.mask, *args, self._dead_zero)
        return pressure_glue.loop_error(self._velocity_divergence(ctx, v_pad), rho_or_count,
                                        alpha_pad, k_sum, ctx.mask, *args)

    def _kick(self, ctx, v_pad, k_pad, scale: float):
        """v - scale (the k-correction of k): the velocity update of a loop
        iteration and of a warm start."""
        if self._slot_glue(ctx):
            return pressure_glue.slot_pressure_kick(v_pad, self._corr_pass(ctx, k_pad), k_pad,
                                                    ctx.sum_grad_stat, ctx.mask, scale,
                                                    self._dead_zero)
        return v_pad - scale * self._k_correction(ctx, k_pad)

    def _gated_iteration(self, ctx, v_pad, rho_or_count, alpha_pad, k_sum, work, dt,
                         scale: float, density: bool, test) -> tuple:
        """(a function of i that enqueues a loop's iteration i, the loop's
        exit-test state) for a loop tested on the device: K5's (K3's) div
        pass, the error kernel, the corr pass on k_i, the kick, each gated on
        the state (ops/pressure_glue.py). Their operands are the loop's own
        for all its iterations (v, k_sum and k_i in place, the passes'
        outputs in buffers of the loop's), so the launchers check them and
        build the arguments once."""
        route, forms, mask, pos = self._route, self._forms, ctx.mask, ctx.pos_pad
        buffers = ki, state = pressure_glue.loop_buffers(work, mask)
        mode = {} if route.rebase is None else dict(rebase=route.rebase)
        div, corr = (torch.empty(mask.shape + (n,), dtype=REAL, device=mask.device)
                     for n in (1, 2))
        launches = (
            route.loop_launcher(forms.div, pos, mask, pos, mask, self._consts, (v_pad,),
                                (v_pad,), div, state, **mode),
            pressure_glue.err_launcher(div[..., 0], v_pad, ctx.sum_grad_stat, rho_or_count,
                                       alpha_pad, k_sum, work, mask,
                                       *self._loop_args(dt, density), self._dead_zero,
                                       buffers, test),
            route.loop_launcher(forms.corr, pos, mask, pos, mask, self._consts, (ki,), (ki,),
                                corr, state, **mode),
            pressure_glue.kick_launcher(v_pad, corr, ki, ctx.sum_grad_stat, mask, scale,
                                        self._dead_zero, state))

        def iteration(i: int):
            for launch in launches:
                launch(i)
        return iteration, state

    def _correct_density_error(self, dt, dens_pad, alpha_pad, v_pad, kappa_pad,
                               prev_iterations, ctx: DenseCtx, n_particles):
        """Constant-density loop (dfsph_dense.py:529-561); returns
        (v, kappa sum, iterations, last average density error). `v_pad` is
        the step's own: on CUDA the loop's kernels update it in place."""
        rho0 = f32(self.properties.fluid_density)
        m = f32(self.properties.particle_mass)
        scale = float((f32(1.0) / f32(dt)) * m)
        if prev_iterations > 1:  # warm start
            k = 0.5 * torch.clamp(kappa_pad, min=float(f32(-0.5) * rho0 * rho0))
            v_pad = self._kick(ctx, v_pad, k, scale)
        return self._pressure_loop(ctx, v_pad, dens_pad, alpha_pad, torch.zeros_like(kappa_pad),
                                   dt, scale, prev_iterations, n_particles, density=True)

    def _correct_divergence_error(self, dt, alpha_pad, v_pad, stiff_pad,
                                  prev_iterations, ctx: DenseCtx, n_particles):
        """Divergence-free loop (dfsph_dense.py:565-598); `v_pad` as in the
        constant-density loop."""
        rho0 = f32(self.properties.fluid_density)
        m = float(f32(self.properties.particle_mass))
        if prev_iterations > 1:  # warm start
            s = 0.5 * torch.clamp(stiff_pad, min=float(f32(-0.5) * rho0 * rho0))
            v_pad = self._kick(ctx, v_pad, s, m)
        return self._pressure_loop(ctx, v_pad, ctx.neighbor_total, alpha_pad,
                                   torch.zeros_like(stiff_pad), dt, m, prev_iterations,
                                   n_particles, density=False)

    def _pressure_loop(self, ctx, v_pad, rho_or_count, alpha_pad, k_sum, dt, scale: float,
                       prev_iterations: int, n_particles, density: bool):
        """A pressure loop's iterations after its warm start -> (v, k_sum,
        iterations, the last iteration's average): the density loop's with
        `density` (`rho_or_count` the densities), else the divergence
        loop's (the neighbour totals). An iteration is the error of v's
        divergence (`_loop_error`), then v's kick by k_i; the loop ends after
        the first iteration whose average `pressure_glue.exit_test` ends, or
        after max + 1 (the JAX exit test).

        With `_device_exit` the test runs on the device, and the host
        enqueues gated iterations ahead of it in chunks (`_gated_iteration`)
        and reads the loop's state back once a chunk: the loop is done once
        the device's count of iterations to run is no more than those
        enqueued. The first chunk is this loop's count in the previous step
        and an eighth more (at least 1); while the device has not stopped the
        loop, the next chunk is a quarter of the iterations enqueued so far
        (at least 2). An iteration enqueued past the loop's end costs its
        four gated launches, which return at once (0.045 device ms on an
        H100 at 1M particles); a chunk too short costs a read-back.
        Elsewhere the host reads each iteration's total back and tests
        it."""
        rho0 = f32(self.properties.fluid_density)
        tol = f32(self.max_avg_density_error if density else self.max_divergence_error)
        cap = self.max_density_iterations if density else self.max_divergence_iterations
        work = pressure_glue.loop_work(ctx.mask) if self._slot_glue(ctx) else None
        if self._device_exit(ctx):
            iteration, state = self._gated_iteration(
                ctx, v_pad, rho_or_count, alpha_pad, k_sum, work, dt, scale, density,
                pressure_glue.ExitTest(float(f32(n_particles)), float(tol), cap))
            enqueued, chunk = 0, max(prev_iterations + prev_iterations // 8, 1)
            while True:
                end = min(enqueued + chunk, cap + 1)
                for i in range(enqueued, end):
                    iteration(i)
                enqueued = end
                num, avg = pressure_glue.read_loop_state(state)
                if num <= enqueued:
                    break
                chunk = max(enqueued // 4, 2)
        else:
            num, goes_on = 0, True
            while num == 0 or (goes_on and num <= cap):
                ki, k_sum, total = self._loop_error(ctx, v_pad, rho_or_count, alpha_pad, k_sum,
                                                    work, dt, density)
                v_pad = self._kick(ctx, v_pad, ki, scale)
                avg, goes_on = pressure_glue.exit_test(self._mean_of_sum(total, n_particles),
                                                       rho0, dt, tol, density)
                num += 1
            enqueued = num
        loop = "density" if density else "divergence"
        pressure_glue.ITERATIONS[f"{loop}_enqueued"] += enqueued
        pressure_glue.ITERATIONS[f"{loop}_run"] += num
        return v_pad, k_sum, num, avg


@contextlib.contextmanager
def _exact_f32_matmul():
    """f32 matmuls in full f32 inside the block (no TF32 on the card), as
    the JAX contraction's f32 result type asks."""
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if precision != "highest":
            torch.set_float32_matmul_precision(precision)


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
        """One simulation step in the JAX step's order (dfsph.rs:414-525), its
        phases in profiler scopes "DFSPH.<phase>" inside "DFSPH.step"
        (utils/profiling.py). A stale step (`rebuild` False) keeps the slot
        layout and refreshes the pair context from the advected positions,
        its drop count the carry's."""
        with scope("DFSPH", "step"):
            ctx = carry.ctx
            time_state = carry.time
            dt = time_state.dt
            n = self._count_live(ctx.mask)
            v_pad = carry.v_pad
            rho_pad = ctx.densities_pad

            with scope("DFSPH", "viscosity"):
                gvec = torch.tensor(self.gravity, dtype=REAL, device=v_pad.device)
                accel = self._viscosity_pass(ctx, v_pad, rho_pad, dt) + gvec

            # CFL with the old-dt estimate (dfsph.rs:472-481)
            with scope("DFSPH", "cfl"):
                vstar = v_pad + accel * float(dt)
                max_velocity = self._max_velocity(vstar, ctx.mask)
                time_state = update_simulation_step(
                    self.step_config, time_state,
                    self.properties.particle_radius * 2.0, max_velocity,
                )
                dt = time_state.dt

            # predict v* with the new dt, constant-density loop (dfsph.rs:484-496)
            pred = v_pad + accel * float(dt)
            with scope("DFSPH", "density_loop"):
                pred, kappa, density_iters, avg_density_error = self._correct_density_error(
                    dt, rho_pad, ctx.alpha_pad, pred, carry.kappa_pad,
                    carry.prev_density_iterations, ctx, n,
                )

            # advect + re-bucket (dfsph.rs:499-512): [v*(2) | kappa | stiffness]
            with scope("DFSPH", "advect"):
                pos = ctx.pos_pad + pred * float(dt)
            if rebuild:
                payload = (pred, kappa, carry.stiff_pad)
                pos, mask, (pred, kappa, stiff), drops = sm_rebucket_parts(
                    pos, ctx.mask, payload, self.grid,
                    halo=self._halo((ctx.mask, pos, *payload)))
                dropped = self._sum_counts(drops) + boundary.num_dropped
            else:
                mask, stiff, dropped = ctx.mask, carry.stiff_pad, ctx.num_dropped
            with scope("DFSPH", "context"):
                ctx = self._ctx_from_padded(pos, mask, boundary, dropped)

            # divergence-free loop (dfsph.rs:521)
            with scope("DFSPH", "divergence_loop"):
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
                neighbor_drops=read_back("drops", ctx.num_dropped),
                density_iterations=density_iters,
                divergence_iterations=divergence_iters,
                avg_density_error=avg_density_error,
                avg_divergence=avg_divergence,
                # migration is structural here: K4's halo rows
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

    def _migrate(self, tree, positions, alive):
        """Move the particles that left this shard's rows to the neighbour
        shards (the sharded sorted solver); one device has nothing to move.
        Returns (tree, particles that could not move)."""
        return tree, 0

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
            (packed, alive), migration_drops = self._migrate((packed, alive), positions, alive)
            # migration may have deadened the rows it sent away: refresh the
            # alive column
            packed = torch.cat([packed[:, :6], alive.to(REAL)[:, None]], dim=1)
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
            migration_drops = 0
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
            neighbor_drops=max(read_back("drops", carry.ctx.num_dropped),
                               read_back("drops", ctx.num_dropped)),
            density_iterations=density_iters,
            divergence_iterations=divergence_iters,
            avg_density_error=avg_density_error,
            avg_divergence=avg_divergence,
            migration_drops=migration_drops,
        )
        return new_carry, diagnostics
