"""Convert the JAX package's solver state into the port's (no JAX needed).

The JAX plane carry stores its planes padded for the TPU, (P, NYP, NXP) with
NYP a multiple of the row band and NXP of the 128-lane vreg; the padded region
is dead by construction (mask False). These converters take the carry's leaves
as numpy arrays and crop them to the port's (P, ny, nx) layout.

`carry_from_numpy` keys (field paths of yasph2d_tpu DFSPHPlaneCarry):
  ctx.pos, ctx.mask, ctx.sum_grad_stat, ctx.neighbor_total, ctx.densities,
  ctx.alpha, ctx.num_dropped, v, kappa, stiff, prev_density_iterations,
  prev_divergence_iterations, time.dt, time.total_simulated_time,
  time.num_steps, time.target_frame_length.
`boundary_from_numpy` keys (fields of yasph2d_tpu BoundaryDense):
  pos_pad, mask, num_dropped.
`dfsph_padded_carry_from_numpy` keys (field paths of yasph2d_tpu
DFSPHPaddedCarry, already in the port's (ny, nx, P[, 2]) layout):
  ctx.pos_pad, ctx.mask, ctx.sum_grad_stat, ctx.neighbor_total,
  ctx.densities_pad, ctx.alpha_pad, ctx.num_dropped, v_pad, kappa_pad,
  stiff_pad, prev_density_iterations, prev_divergence_iterations, time.*;
  and, where the loop-gradient variants cached them, ctx.grad_dyn (f32, or
  bfloat16 as numpy holds it: the ml_dtypes type or two raw bytes) and
  ctx.sum_grad_dyn.
`wcsph_padded_carry_from_numpy` keys (fields of yasph2d_tpu WCSPHPaddedCarry,
already in the port's (ny, nx, P[, 2]) layout): pos_pad, v_pad, accel_pad,
  dens_pad, mask, time.*.
`wcsph_plane_carry_from_numpy` keys (fields of yasph2d_tpu WCSPHPlaneCarry,
cropped): pos, v, accel, dens, mask, time.*.
`dfsph_table_carry_from_numpy` keys (field paths of yasph2d_tpu DFSPHCarry):
  particles.{positions, velocities, densities, alive}, alpha,
  warmstart_kappa, warmstart_stiffness, neighborhood.{dynamic, static}.{idx,
  mask, count, num_dropped}, prev_density_iterations,
  prev_divergence_iterations, time.*.
`wcsph_table_carry_from_numpy` (yasph2d_tpu WCSPHCarry) and
`wcsph_dense_carry_from_numpy` (WCSPHDenseCarry) keys: particles.*,
  accelerations, time.*.
`dfsph_dense_carry_from_numpy` keys (field paths of yasph2d_tpu
DFSPHDenseCarry): particles.*, alpha, warmstart_stiffness, v_pad, kappa_pad,
  stiff_pad, ctx.{pos_pad, mask, sum_grad_stat, neighbor_total,
  densities_pad, alpha_pad, num_dropped}, ctx.slots.{slot_idx, slot_mask,
  inverse, in_grid, num_dropped}, prev_density_iterations,
  prev_divergence_iterations, time.* (the JAX slot-major route's TPU band
  geometry, ctx.sm.*, has no counterpart and is not read), ctx.grad_dyn and
  ctx.sum_grad_dyn as for the padded carry. One shard's block of a JAX
  sharded sorted carry converts the same way; the sharded driver's
  `resume` then exchanges its halo rows.

Every converter makes its tensors on the card unless given a `device` (the
CPU tests pass device="cpu"). `carry_from_numpy` and `boundary_from_numpy`
build K1's geometry under the grid's `pair_dtype` (ops/planes.plane_geom),
so a bfloat16 grid gets the rebased bf16 geometry the plane solvers use.
"""

import numpy as np
import torch

from ..models.dfsph import DFSPHCarry
from ..models.dfsph_dense import BoundaryDense, DenseCtx, DFSPHDenseCarry, DFSPHPaddedCarry
from ..models.dfsph_plane import BoundaryPlanes, DFSPHPlaneCarry, PlaneCtx
from ..models.wcsph import WCSPHCarry
from ..models.wcsph_dense import WCSPHDenseCarry, WCSPHPaddedCarry
from ..models.wcsph_plane import WCSPHPlaneCarry
from ..ops.dense_grid import DenseGridConfig, SlotGrid
from ..ops.neighborhood import Neighborhood, NeighborTable
from ..ops.planes import PlaneGeom, plane_geom, to_planes
from ..timemanager import TimeState
from ..units import INDEX, REAL
from ..world import ParticleState


def carry_from_numpy(leaves: dict, grid: DenseGridConfig, device="cuda") -> DFSPHPlaneCarry:
    ny, nx = grid.ny, grid.nx

    def plane(key, dtype=REAL):
        a = np.array(np.asarray(leaves[key])[..., :ny, :nx])  # writable copy
        return torch.as_tensor(a, device=device).to(dtype)

    def scalar(key):
        return torch.as_tensor(np.array(leaves[key]), device=device).to(INDEX)

    pos, mask = plane("ctx.pos"), plane("ctx.mask", torch.bool)
    ctx = PlaneCtx(
        pos=pos,
        mask=mask,
        sum_grad_stat=plane("ctx.sum_grad_stat"),
        neighbor_total=plane("ctx.neighbor_total"),
        densities=plane("ctx.densities"),
        alpha=plane("ctx.alpha"),
        num_dropped=scalar("ctx.num_dropped"),
        geom=plane_geom(pos, mask, grid),
    )
    return DFSPHPlaneCarry(
        ctx=ctx,
        v=plane("v"),
        kappa=plane("kappa"),
        stiff=plane("stiff"),
        prev_density_iterations=int(leaves["prev_density_iterations"]),
        prev_divergence_iterations=int(leaves["prev_divergence_iterations"]),
        time=_time(leaves),
    )


def _time(leaves: dict) -> TimeState:
    return TimeState(
        dt=np.float32(leaves["time.dt"]),
        total_simulated_time=np.float32(leaves["time.total_simulated_time"]),
        num_steps=np.int32(leaves["time.num_steps"]),
        target_frame_length=np.float32(leaves["time.target_frame_length"]),
    )


def _bf16_or_f32(a, device) -> torch.Tensor:
    """A float leaf as a tensor: bfloat16 (numpy's ml_dtypes type, or the
    raw two bytes an element of an .npz) bit for bit, else f32."""
    a = np.array(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.as_tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.as_tensor(a, device=device).to(REAL)


def dfsph_padded_carry_from_numpy(leaves: dict, device="cuda") -> DFSPHPaddedCarry:
    def slots(key, dtype=REAL):
        return torch.as_tensor(np.array(leaves[key]), device=device).to(dtype)

    def cached(key):
        return _bf16_or_f32(leaves[key], device) if key in leaves else None

    ctx = DenseCtx(
        pos_pad=slots("ctx.pos_pad"),
        mask=slots("ctx.mask", torch.bool),
        sum_grad_stat=slots("ctx.sum_grad_stat"),
        neighbor_total=slots("ctx.neighbor_total"),
        densities_pad=slots("ctx.densities_pad"),
        alpha_pad=slots("ctx.alpha_pad"),
        num_dropped=slots("ctx.num_dropped", INDEX),
        grad_dyn=cached("ctx.grad_dyn"),
        sum_grad_dyn=cached("ctx.sum_grad_dyn"),
    )
    return DFSPHPaddedCarry(
        ctx=ctx,
        v_pad=slots("v_pad"),
        kappa_pad=slots("kappa_pad"),
        stiff_pad=slots("stiff_pad"),
        prev_density_iterations=int(leaves["prev_density_iterations"]),
        prev_divergence_iterations=int(leaves["prev_divergence_iterations"]),
        time=_time(leaves),
    )


def wcsph_padded_carry_from_numpy(leaves: dict, device="cuda") -> WCSPHPaddedCarry:
    def slots(key, dtype=REAL):
        return torch.as_tensor(np.array(leaves[key]), device=device).to(dtype)

    return WCSPHPaddedCarry(
        pos_pad=slots("pos_pad"), v_pad=slots("v_pad"), accel_pad=slots("accel_pad"),
        dens_pad=slots("dens_pad"), mask=slots("mask", torch.bool), time=_time(leaves),
    )


def wcsph_plane_carry_from_numpy(leaves: dict, grid: DenseGridConfig,
                                 device="cuda") -> WCSPHPlaneCarry:
    def plane(key, dtype=REAL):
        a = np.array(np.asarray(leaves[key])[..., :grid.ny, :grid.nx])  # writable copy
        return torch.as_tensor(a, device=device).to(dtype)

    return WCSPHPlaneCarry(
        pos=plane("pos"), v=plane("v"), accel=plane("accel"), dens=plane("dens"),
        mask=plane("mask", torch.bool), time=_time(leaves),
    )


def _leaf_tree(cls, leaves: dict, prefix: str, device):
    """`cls` (a NamedTuple of tensors) from the leaves `prefix` + field, each
    in its stored dtype."""
    return cls(*(torch.as_tensor(np.array(leaves[prefix + f]), device=device)
                 for f in cls._fields))


def dfsph_table_carry_from_numpy(leaves: dict, device="cuda") -> DFSPHCarry:
    def tensor(key):
        return torch.as_tensor(np.array(leaves[key]), device=device)

    return DFSPHCarry(
        particles=_leaf_tree(ParticleState, leaves, "particles.", device),
        alpha=tensor("alpha"),
        warmstart_kappa=tensor("warmstart_kappa"),
        warmstart_stiffness=tensor("warmstart_stiffness"),
        neighborhood=Neighborhood(*(_leaf_tree(NeighborTable, leaves, f"neighborhood.{t}.",
                                               device) for t in Neighborhood._fields)),
        prev_density_iterations=int(leaves["prev_density_iterations"]),
        prev_divergence_iterations=int(leaves["prev_divergence_iterations"]),
        time=_time(leaves),
    )


def wcsph_table_carry_from_numpy(leaves: dict, device="cuda") -> WCSPHCarry:
    return WCSPHCarry(
        particles=_leaf_tree(ParticleState, leaves, "particles.", device),
        accelerations=torch.as_tensor(np.array(leaves["accelerations"]), device=device),
        time=_time(leaves),
    )


def wcsph_dense_carry_from_numpy(leaves: dict, device="cuda") -> WCSPHDenseCarry:
    return WCSPHDenseCarry(*wcsph_table_carry_from_numpy(leaves, device))


def dfsph_dense_carry_from_numpy(leaves: dict, device="cuda") -> DFSPHDenseCarry:
    def tensor(key):
        return torch.as_tensor(np.array(leaves[key]), device=device)

    padded = dfsph_padded_carry_from_numpy(leaves, device)
    return DFSPHDenseCarry(
        particles=_leaf_tree(ParticleState, leaves, "particles.", device),
        alpha=tensor("alpha"),
        warmstart_stiffness=tensor("warmstart_stiffness"),
        v_pad=padded.v_pad,
        kappa_pad=padded.kappa_pad,
        stiff_pad=padded.stiff_pad,
        ctx=padded.ctx._replace(slots=_leaf_tree(SlotGrid, leaves, "ctx.slots.", device)),
        prev_density_iterations=padded.prev_density_iterations,
        prev_divergence_iterations=padded.prev_divergence_iterations,
        time=padded.time,
    )


def boundary_from_numpy(leaves: dict, grid: DenseGridConfig = None,
                        device="cuda") -> BoundaryPlanes:
    """The boundary's dense build and K1's plane geometry of it, under
    `grid.pair_dtype` (float32 when no grid is given)."""
    dense = BoundaryDense(
        pos_pad=torch.as_tensor(np.array(leaves["pos_pad"]), dtype=REAL, device=device),
        mask=torch.as_tensor(np.array(leaves["mask"]), dtype=torch.bool, device=device),
        num_dropped=torch.as_tensor(np.array(leaves["num_dropped"]), device=device).to(INDEX),
    )
    pos, mask = to_planes(dense.pos_pad), to_planes(dense.mask)
    geom = PlaneGeom(pos, mask) if grid is None else plane_geom(pos, mask, grid)
    return BoundaryPlanes(dense=dense, geom=geom)
