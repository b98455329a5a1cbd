"""DFSPH with a plane-resident carry (PyTorch port of
yasph2d_tpu/models/dfsph_plane.py; reference: src/sph/solver/dfsph.rs:414-525).

The state lives as planes, (P, ny, nx) for scalars and (2, P, ny, nx) for
vectors (ops/planes.py). Every pair pass of the step is one call form of the
pair kernel K1 (ops/pair_reduce.py) with the pressure loops' elementwise glue
fused into its epilogue, and the per-step neighbourhood rebuild is the
re-bucket kernel K2 (ops/rebucket.py):

    ctx          fluid -> boundary sums (W, m grad W, |m grad W|^2, count)
    ctx_post     fluid -> fluid sums, epilogue: density, alpha, neighbour total
    visc_gravity viscosity + gravity (XSPH; visc_gravity_phys for the
                 physical model)
    err_ki       velocity divergence, epilogue: density error and k_i
    delta_ki     velocity divergence, epilogue: divergence and k_i
    corr_v       k-correction, epilogue: velocity update (warm starts + loops)

The JAX switches `fuse_ctx_elementwise` and `fuse_loop_elementwise` (both
True by default) take the glue out of the epilogues. With the first False
the fluid ctx pass is `ctx` on fluid sources and the density / alpha /
neighbour-total assembly runs in torch; with the second False the step's
passes are the no-epilogue forms

    visc         viscosity (visc_phys for the physical model); + gravity
    div          velocity divergence
    corr         k-correction

and the warm starts and loop bodies run in torch (the JAX
`_velocity_divergence_pf` and `_k_correction_pf`): the same f32 operations
in the same order as the epilogues, one torch operation each, so live slots
are bit-equal between the fused and unfused steps (dead slots hold what the
glue makes of the kernels' zeros; nothing reads them).

Both pressure loops are the padded solver's (models/dfsph_dense.py), this
solver giving their iteration (`_loop_error`, `_kick`) on K1: host loops
that read one residual back per iteration, with the JAX exit test (a loop
may run max + 1 times). The f32 scalars that reach the kernels (dt, 1/dt *
m) are computed in np.float32 exactly as JAX computes them on device. A
stale step of `rebuild_every` > 1 skips K2 and rebuilds the ctx (and K1's
geometry) from the advected positions in the old layout, as the padded
solver does.

Spatial sharding (parallel/shard_plane.py) overrides the hooks of
models/slot_solver.py: `_halo` (the neighbour shards' rows -1 and ny of a
set of planes) makes every geometry, pass and re-bucket take the kernels'
halo forms, and the live count, the CFL max and the drop and residual sums
are global. `PlanePasses`, K1's geometry and pass and the boundary's planes,
is shared with the WCSPH plane solver (models/wcsph_plane.py).
"""

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.pair_reduce import PairForm, pair_reduce
from ..ops.planes import PlaneGeom, from_planes, plane_geom, to_planes
from ..ops.rebucket import rebucket_planes
from ..timemanager import TimeState, update_simulation_step
from ..units import REAL
from ..utils.diagnostics import Diagnostics
from ..utils.profiling import read_back
from ..world import ParticleState
from .dfsph_dense import ALPHA_EPSILON, BoundaryDense, DFSPHPaddedSolver


class BoundaryPlanes(NamedTuple):
    """Static index space: the dense build plus its plane-form geometry."""

    dense: BoundaryDense
    geom: PlaneGeom


class PlaneCtx(NamedTuple):
    """Per-rebuild pair context in plane form."""

    pos: torch.Tensor  # (2, P, ny, nx)
    mask: torch.Tensor  # (P, ny, nx) bool
    sum_grad_stat: torch.Tensor  # (2, P, ny, nx): sum grad W to boundary
    neighbor_total: torch.Tensor  # (P, ny, nx) f32
    densities: torch.Tensor  # (P, ny, nx) clamped density
    alpha: torch.Tensor  # (P, ny, nx)
    num_dropped: torch.Tensor  # () int32
    geom: PlaneGeom  # K1's geometry of this rebuild (ops/planes.plane_geom)


class DFSPHPlaneCarry(NamedTuple):
    ctx: PlaneCtx
    v: torch.Tensor  # (2, P, ny, nx)
    kappa: torch.Tensor  # (P, ny, nx) density-loop warm start
    stiff: torch.Tensor  # (P, ny, nx) divergence-loop warm start
    prev_density_iterations: int
    prev_divergence_iterations: int
    time: TimeState


class _Forms(NamedTuple):
    ctx: PairForm
    ctx_post: PairForm
    visc_gravity: PairForm
    err_ki: PairForm
    delta_ki: PairForm
    corr_v: PairForm
    visc: PairForm  # the unfused step's no-epilogue passes
    div: PairForm
    corr: PairForm


class PlanePasses:
    """What the plane solvers (this module's and models/wcsph_plane.py's)
    share: K1's geometry and pass under the shard solvers' hooks, and the
    boundary's planes. K1 takes bf16 operands (ops/pair_reduce.py) on the
    slot-major route, where the padded solvers (K3) refuse them."""

    _bf16_operands = True

    def _geom(self, pos, mask) -> PlaneGeom:
        """K1's geometry of one index space (planes.plane_geom), with the
        neighbours' rows of its positions and mask under sharding."""
        geom = plane_geom(pos, mask, self.grid, self._rebucket_row0())
        halo = self._halo((geom.pos, geom.mask))
        return geom if halo is None else geom._replace(halo=halo)

    def _pair(self, form: PairForm, q: PlaneGeom, s: PlaneGeom, q_vals=(), s_vals=(),
              scalars=(), post_planes=()):
        """One K1 pass; a source geometry with a halo takes its value planes'
        rows from the neighbours too, one exchange per pass."""
        s_halo = () if s.halo is None or not s_vals else self._halo(s_vals).planes
        return pair_reduce(form, q, s, self._consts, q_vals=q_vals, s_vals=s_vals,
                           scalars=scalars, post_planes=post_planes, s_halo=s_halo)

    def boundary_planes(self, boundary: BoundaryDense) -> BoundaryPlanes:
        """Plane-form boundary geometry under `grid.pair_dtype`; build once per
        boundary change."""
        return BoundaryPlanes(
            dense=boundary,
            geom=self._geom(to_planes(boundary.pos_pad), to_planes(boundary.mask)),
        )


@dataclass(frozen=True)
class DFSPHPlaneSolver(PlanePasses, DFSPHPaddedSolver):
    """DFSPH, plane-resident carry, every pass through the pair kernel. Takes
    `grid.pair_dtype` "float32" or "bfloat16" (K1's bf16 operand mode)."""

    # the loops' and the ctx assembly's glue in K1's epilogues (the JAX
    # fields; False runs it in torch, module docstring)
    fuse_loop_elementwise: bool = True
    fuse_ctx_elementwise: bool = True

    def __post_init__(self):
        assert self.grid.use_pallas_slotmajor, (
            "DFSPHPlaneSolver is the plane-resident slot-major path; set "
            "DenseGridConfig.use_pallas_slotmajor=True"
        )
        super().__post_init__()

    def _make_forms(self, m: float, route) -> _Forms:
        """The K1 call forms: their math as Python callables (the twin's),
        op for op the JAX closures of models/dfsph_plane.py."""
        kernel = self.kernel
        rho0, w0 = float(self.properties.fluid_density), self._w0
        eps = float(ALPHA_EPSILON)
        gx, gy = float(self.gravity[0]), float(self.gravity[1])

        def ctx_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
            w = kernel.evaluate(r_sq, r)
            mgc = kernel.gradient_coefficient(r_sq, r) * m
            gx_ = mgc * dx
            gy_ = mgc * dy
            return (w, gx_, gy_, gx_ * gx_ + gy_ * gy_, torch.ones_like(r_sq))

        def ctx_post(accs, post_planes, scalars):
            d0, d1, d2, d3, d4 = accs
            s0, s1, s2, s3, s4 = post_planes
            dens = torch.clamp(m * ((w0 + d0) + s0), min=rho0)
            vx = d1 + s1
            vy = d2 + s2
            denom = ((vx * vx) + (vy * vy)) + d3 + s3
            return (dens, 1.0 / torch.clamp(denom, min=eps), d4 + s4)

        def visc_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
            c = self.viscosity_model.viscous_coefficient(
                scalars[0], r_sq, r, m, s_planes[2]
            )
            return (c * (s_planes[0] - q_planes[0]), c * (s_planes[1] - q_planes[1]))

        def gravity_post(accs, post_planes, scalars):
            return (accs[0] + gx, accs[1] + gy)

        def div_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
            gc = kernel.gradient_coefficient(r_sq, r)
            return (
                ((q_planes[0] - s_planes[0]) * dx
                 + (q_planes[1] - s_planes[1]) * dy) * gc,
            )

        def err_post(accs, post_planes, scalars):
            vx, vy, sgx, sgy, dens_p, alpha_p = post_planes
            delta = accs[0] + (vx * sgx + vy * sgy)
            err = torch.clamp(dens_p + delta * m * scalars[0], min=rho0) - rho0
            return (err, err * alpha_p)

        def delta_post(accs, post_planes, scalars):
            vx, vy, sgx, sgy, nt, alpha_p = post_planes
            delta = (accs[0] + (vx * sgx + vy * sgy)) * m
            delta = torch.clamp(delta, min=0.0)
            # particle-deficiency guard (<9 total neighbors, dfsph.rs:260-264)
            delta = torch.where(nt < 9, 0.0, delta)
            return (delta, delta * alpha_p)

        def corr_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
            kk = (q_planes[0] + s_planes[0]) * kernel.gradient_coefficient(r_sq, r)
            return (kk * dx, kk * dy)

        def v_post(accs, post_planes, scalars):
            vx, vy, kp, sgx, sgy = post_planes
            s = scalars[0]
            return (vx - s * (accs[0] + kp * sgx), vy - s * (accs[1] + kp * sgy))

        return _Forms(
            ctx=PairForm("ctx", 5, ctx_terms),
            ctx_post=PairForm("ctx_post", 3, ctx_terms, ctx_post, n_acc=5),
            visc_gravity=PairForm("visc_gravity" + self._visc_suffix, 2, visc_terms,
                                  gravity_post),
            err_ki=PairForm("err_ki", 2, div_terms, err_post, n_acc=1),
            delta_ki=PairForm("delta_ki", 2, div_terms, delta_post, n_acc=1),
            corr_v=PairForm("corr_v", 2, corr_terms, v_post, n_acc=2),
            visc=PairForm("visc" + self._visc_suffix, 2, visc_terms),
            div=PairForm("div", 1, div_terms),
            corr=PairForm("corr", 2, corr_terms),
        )

    # ------------------------------------------------------------ pair context

    def _ctx_pf(self, pos, mask, boundary: BoundaryPlanes, dropped) -> PlaneCtx:
        """Fluid-boundary and fluid-fluid ctx passes: density, alpha and
        neighbour totals, plus the boundary gradient sums the loops reuse. K1's
        geometry is built here, once per rebuild, and kept in the ctx. The
        assembly is ctx_post's epilogue, or with `fuse_ctx_elementwise`
        False the same function in torch over the `ctx` form's sums."""
        geom = self._geom(pos, mask)
        f = self._forms
        stat = self._pair(f.ctx, geom, boundary.geom)
        if self.fuse_ctx_elementwise:
            fused = self._pair(f.ctx_post, geom, geom, post_planes=(stat,))
        else:
            dyn = self._pair(f.ctx, geom, geom)
            fused = f.ctx_post.post_fn(list(dyn), tuple(stat), ())
        m = torch.tensor(self.properties.particle_mass, dtype=REAL, device=pos.device)
        return PlaneCtx(
            pos=pos,
            mask=mask,
            # a tensor divisor: a Python one would become a reciprocal multiply
            # on CUDA, one ulp away from the JAX package's true division
            sum_grad_stat=stat[1:3] / m,
            neighbor_total=fused[2],
            densities=fused[0],
            alpha=fused[1],
            num_dropped=dropped,
            geom=geom,
        )

    # --------------------------------------------------------------- pair ops

    def _viscosity_gravity_pf(self, ctx: PlaneCtx, v, rho, dt):
        """Viscous acceleration + gravity, (2, P, ny, nx)."""
        return self._pair(self._forms.visc_gravity, ctx.geom, ctx.geom,
                          q_vals=(v,), s_vals=(v, rho), scalars=(float(dt),))

    def _density_err_ki_pf(self, ctx: PlaneCtx, v, dens, alpha, dt):
        """Velocity divergence -> (density error, k_i) planes (dfsph.rs:99-161)."""
        out = self._pair(self._forms.err_ki, ctx.geom, ctx.geom,
                         q_vals=(v,), s_vals=(v,), scalars=(float(dt),),
                         post_planes=(v, ctx.sum_grad_stat, dens, alpha))
        return out[0], out[1]

    def _divergence_delta_ki_pf(self, ctx: PlaneCtx, v):
        """Velocity divergence -> (divergence, k_i) planes (dfsph.rs:249-280)."""
        out = self._pair(self._forms.delta_ki, ctx.geom, ctx.geom,
                         q_vals=(v,), s_vals=(v,),
                         post_planes=(v, ctx.sum_grad_stat, ctx.neighbor_total,
                                      ctx.alpha))
        return out[0], out[1]

    def _apply_correction_pf(self, ctx: PlaneCtx, k, v, scale):
        """k-correction -> updated velocity planes (dfsph.rs:128-161)."""
        return self._pair(self._forms.corr_v, ctx.geom, ctx.geom,
                          q_vals=(k,), s_vals=(k,), scalars=(float(scale),),
                          post_planes=(v, k, ctx.sum_grad_stat))

    # ----------------------------------- the unfused step's passes (no epilogue)

    def _viscosity_pf(self, ctx: PlaneCtx, v, rho, dt):
        """Viscous acceleration over fluid neighbours, (2, P, ny, nx)."""
        return self._pair(self._forms.visc, ctx.geom, ctx.geom,
                          q_vals=(v,), s_vals=(v, rho), scalars=(float(dt),))

    def _velocity_divergence(self, ctx: PlaneCtx, v):
        """sum_dyn (v_i - v_j).grad + v_i.sum_grad_stat (JAX
        `_velocity_divergence_pf`); the padded loops call it."""
        dyn = self._pair(self._forms.div, ctx.geom, ctx.geom, q_vals=(v,), s_vals=(v,))[0]
        sgs = ctx.sum_grad_stat
        return dyn + (v[0] * sgs[0] + v[1] * sgs[1])

    def _k_correction(self, ctx: PlaneCtx, k):
        """sum_dyn (k_i + k_j) grad + k_i sum_grad_stat, (2, P, ny, nx) (JAX
        `_k_correction_pf`); the padded loops call it."""
        dyn = self._pair(self._forms.corr, ctx.geom, ctx.geom, q_vals=(k,), s_vals=(k,))
        return dyn + k[None] * ctx.sum_grad_stat

    # ------------------------------------------------------------- reductions

    def _max_velocity_pf(self, vstar, mask) -> np.float32:
        return self._max_vel_from_sq(torch.where(mask, (vstar * vstar).sum(dim=0), 0.0))

    # ------------------------- the padded solver's pressure loops on K1's passes

    @staticmethod
    def _slot_glue(ctx) -> bool:
        """The plane layout's loop glue is K1's epilogues, or torch's: never
        ops/pressure_glue.py's kernels."""
        return False

    def _loop_error(self, ctx: PlaneCtx, v, rho_or_count, alpha, k_sum, work, dt,
                    density: bool):
        """err_ki's or delta_ki's epilogue; unfused, the div pass and the
        padded solver's torch glue."""
        if not self.fuse_loop_elementwise:
            return super()._loop_error(ctx, v, rho_or_count, alpha, k_sum, work, dt, density)
        err, ki = (self._density_err_ki_pf(ctx, v, rho_or_count, alpha, dt) if density
                   else self._divergence_delta_ki_pf(ctx, v))
        return ki, k_sum + ki, torch.where(ctx.mask, err, 0.0).sum()

    def _kick(self, ctx: PlaneCtx, v, k, scale: float):
        """corr_v's epilogue; unfused, the corr pass and torch."""
        if not self.fuse_loop_elementwise:
            return super()._kick(ctx, v, k, scale)
        return self._apply_correction_pf(ctx, k, v, scale)

    # ------------------------------------------------------------- host bounds

    def init_carry(self, state: ParticleState, boundary) -> DFSPHPlaneCarry:
        """`boundary` may be a BoundaryDense or a prebuilt BoundaryPlanes. The
        ctx is built directly with the plane passes (the JAX package builds a
        padded ctx first and discards it)."""
        if isinstance(boundary, BoundaryDense):
            boundary = self.boundary_planes(boundary)
        base = self._padded_init(state, boundary.dense)
        pos = to_planes(base.pos_pad)
        mask = to_planes(base.mask)
        ctx = self._ctx_pf(pos, mask, boundary, base.num_dropped)
        return DFSPHPlaneCarry(
            ctx=ctx,
            v=to_planes(base.v_pad),
            kappa=to_planes(base.kappa_pad),
            stiff=to_planes(base.stiff_pad),
            prev_density_iterations=base.prev_density_iterations,
            prev_divergence_iterations=base.prev_divergence_iterations,
            time=base.time,
        )

    def export_state(self, carry: DFSPHPlaneCarry) -> ParticleState:
        """Flat slot-order view: N = ny*nx*P rows with the slot mask as `alive`
        (the JAX export's row order)."""
        mask = from_planes(carry.ctx.mask).reshape(-1)
        rho0 = float(self.properties.fluid_density)
        return ParticleState(
            positions=from_planes(carry.ctx.pos).reshape(-1, 2),
            velocities=torch.where(
                mask[:, None], from_planes(carry.v).reshape(-1, 2), 0.0
            ),
            densities=torch.where(
                mask, from_planes(carry.ctx.densities).reshape(-1), rho0
            ),
            alive=mask,
        )

    # -------------------------------------------------------------------- step

    def step(self, carry: DFSPHPlaneCarry, boundary: BoundaryPlanes,
             rebuild: bool = True):
        """One simulation step in the JAX step's order (dfsph.rs:414-525); a
        stale step (`rebuild` False) as the padded solver's."""
        ctx = carry.ctx
        time_state = carry.time
        dt = time_state.dt
        n = self._count_live(ctx.mask)
        v = carry.v
        rho = ctx.densities

        if self.fuse_loop_elementwise:
            accel = self._viscosity_gravity_pf(ctx, v, rho, dt)
        else:
            gvec = torch.tensor(self.gravity, dtype=REAL, device=v.device)
            accel = self._viscosity_pf(ctx, v, rho, dt) + gvec[:, None, None, None]

        # CFL with the old-dt estimate (dfsph.rs:472-481)
        vstar = v + accel * float(dt)
        max_velocity = self._max_velocity_pf(vstar, ctx.mask)
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )
        dt = time_state.dt

        # predict v* with the new dt, constant-density loop (dfsph.rs:484-496)
        pred = v + accel * float(dt)
        pred, kappa, density_iters, avg_density_error = self._correct_density_error(
            dt, rho, ctx.alpha, pred, carry.kappa,
            carry.prev_density_iterations, ctx, n,
        )

        # advect + re-bucket (dfsph.rs:499-512)
        pos = ctx.pos + pred * float(dt)
        if rebuild:
            payload = (pred, kappa, carry.stiff)
            pos, mask, (pred, kappa, stiff), drops = rebucket_planes(
                pos, ctx.mask, payload, self.grid,
                halo=self._halo((ctx.mask, pos, *payload)))
            drops = self._sum_counts(drops)
            ctx = self._ctx_pf(pos, mask, boundary, drops + boundary.dense.num_dropped)
        else:
            stiff = carry.stiff
            ctx = self._ctx_pf(pos, ctx.mask, boundary, ctx.num_dropped)

        # divergence-free loop (dfsph.rs:521)
        pred, stiff, divergence_iters, avg_divergence = self._correct_divergence_error(
            dt, ctx.alpha, pred, stiff, carry.prev_divergence_iterations, ctx, n,
        )

        new_carry = DFSPHPlaneCarry(
            ctx=ctx,
            v=pred,
            kappa=kappa,
            stiff=stiff,
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
            migration_drops=0,
        )
        return new_carry, diagnostics
