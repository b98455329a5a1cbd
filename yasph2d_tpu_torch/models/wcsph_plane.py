"""WCSPH with a plane-resident carry (PyTorch port of
yasph2d_tpu/models/wcsph_plane.py; reference: src/sph/solver/wscsph.rs:126-179).

Same algorithm and step order as the padded solver (models/wcsph_dense.py);
only the resident layout differs, as the DFSPH plane solver relates to the
padded init (models/dfsph_plane.py): scalars (P, ny, nx), vectors
(2, P, ny, nx). The three pair passes are K1 call forms (ops/pair_reduce.py)
and the rebuild is K2 (ops/rebucket.py) with the velocity as its payload:

    wcsph_density   fluid Poly6 density sums
    wcsph_stat      boundary density + Monaghan-Kajtar force, against the
                    boundary's plane geometry
    wcsph_forces    symmetric pressure + XSPH viscosity (wcsph_forces_phys
                    with PhysicalViscosityModel)

The TPU-only stat-pass column chunking (pf_stat_chunk_kw) is not ported: the
kernel has no column chunks. The hooks of spatial sharding
(parallel/shard_plane.py) are the slot solvers' (models/slot_solver.py:
`_halo`, the CFL max `_max_vel_from_sq`, the drop sum `_sum_counts`), under
K1's geometry and pass `_geom` and `_pair`, which both plane solvers take
from models/dfsph_plane.PlanePasses.
"""

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.planes import from_planes, to_planes
from ..ops.rebucket import rebucket
from ..timemanager import TimeState, update_simulation_step
from ..units import REAL, REAL_NP
from ..ops.slot_glue import tait_pressure
from ..utils.diagnostics import Diagnostics
from ..utils.profiling import read_back
from ..world import ParticleState
from .dfsph_plane import BoundaryPlanes, PlanePasses
from .wcsph_dense import WCSPHPaddedSolver

f32 = REAL_NP


class WCSPHPlaneCarry(NamedTuple):
    """Plane-form twin of WCSPHPaddedCarry."""

    pos: torch.Tensor  # (2, P, ny, nx)
    v: torch.Tensor  # (2, P, ny, nx)
    accel: torch.Tensor  # (2, P, ny, nx) cached for the leapfrog (wscsph.rs:21-22)
    dens: torch.Tensor  # (P, ny, nx) last computed densities
    mask: torch.Tensor  # (P, ny, nx) bool
    time: TimeState


@dataclass(frozen=True)
class WCSPHPlaneSolver(PlanePasses, WCSPHPaddedSolver):
    """WCSPH, plane-resident carry, every pass through K1 and K2. Takes
    `grid.pair_dtype` "float32" or "bfloat16" (K1's bf16 operand mode)."""

    def __post_init__(self):
        assert self.grid.use_pallas_slotmajor, (
            "WCSPHPlaneSolver is the plane-resident slot-major path; set "
            "DenseGridConfig.use_pallas_slotmajor=True"
        )
        super().__post_init__()

    def _density(self, dyn_w, stat_w):
        """m (W(0) + dyn + stat), clamped to rho0 (fluidparticleworld.rs:197-231)."""
        m = float(self.properties.particle_mass)
        dens = m * ((self._w0 + dyn_w) + stat_w)
        return torch.clamp(dens, min=self.properties.fluid_density)

    def init_carry(self, state: ParticleState, boundary=None) -> WCSPHPlaneCarry:
        """The padded init in plane form. `boundary` is accepted so that every
        solver's init_carry takes the same arguments, and ignored."""
        base = WCSPHPaddedSolver.init_carry(self, state)
        return WCSPHPlaneCarry(
            pos=to_planes(base.pos_pad),
            v=to_planes(base.v_pad),
            accel=to_planes(base.accel_pad),
            dens=to_planes(base.dens_pad),
            mask=to_planes(base.mask),
            time=base.time,
        )

    def export_state(self, carry: WCSPHPlaneCarry) -> ParticleState:
        """Flat slot-order view (the padded export's row order: N = ny*nx*P
        with the slot mask as `alive`)."""
        mask = from_planes(carry.mask).reshape(-1)
        return ParticleState(
            positions=from_planes(carry.pos).reshape(-1, 2),
            velocities=torch.where(mask[:, None], from_planes(carry.v).reshape(-1, 2),
                                   0.0),
            densities=torch.where(mask, from_planes(carry.dens).reshape(-1),
                                  self.properties.fluid_density),
            alive=mask,
        )

    def step(self, carry: WCSPHPlaneCarry, boundary: BoundaryPlanes):
        """One simulation step, in the padded step's order, in plane form."""
        time_state = carry.time
        dt = time_state.dt
        f = self._forms

        # leapfrog part 1 in the OLD layout (wscsph.rs:141-151)
        v = carry.v + float(f32(0.5) * dt) * carry.accel
        pos = carry.pos + v * float(dt)

        # neighbourhood rebuild = plane-form re-bucket (wscsph.rs:153)
        pos, mask, v, drops = rebucket(pos, carry.mask, v, self.grid,
                                       halo=self._halo((carry.mask, pos, v)))

        # density passes (fluidparticleworld.rs:197-231 + wscsph.rs:108-116)
        # on K1's geometry of this rebuild
        geom = self._geom(pos, mask)
        dyn_w = self._pair(f.density, geom, geom)[0]
        stat = self._pair(f.stat, geom, boundary.geom)
        dens = self._density(dyn_w, stat[0])
        pres = tait_pressure(self.stiffness, self.properties.fluid_density, dens)

        # symmetric pressure + viscosity forces (wscsph.rs:59-105)
        accel = self._pair(f.forces, geom, geom, q_vals=(pres, dens, v),
                           s_vals=(pres, dens, v), scalars=(float(dt),))
        gvec = torch.tensor(self.gravity, dtype=REAL, device=pos.device).reshape(2, 1, 1, 1)
        # dead slots stay frozen: no gravity, no advection
        accel = torch.where(mask[None], (accel + stat[1:3]) + gvec, 0.0)

        # CFL with the *old* dt estimate (wscsph.rs:158-167)
        vstar = v + accel * float(dt)
        max_velocity = self._max_vel_from_sq(
            torch.where(mask, (vstar * vstar).sum(dim=0), 0.0))
        time_state = update_simulation_step(
            self.step_config, time_state,
            self.properties.particle_radius * 2.0, max_velocity,
        )

        # leapfrog part 2 with the NEW dt (wscsph.rs:169-178)
        v = v + float(f32(0.5) * time_state.dt) * accel

        new_carry = WCSPHPlaneCarry(
            pos=pos, v=v, accel=accel, dens=dens, mask=mask, time=time_state
        )
        diagnostics = Diagnostics.zeros()._replace(
            dt=dt,
            max_velocity=max_velocity,
            neighbor_drops=read_back("drops", self._sum_counts(drops)
                                     + boundary.dense.num_dropped),
        )
        return new_carry, diagnostics
