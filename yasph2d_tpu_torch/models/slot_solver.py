"""What the port's slot-layout solvers share: `SlotSolver`, the base of the
DFSPH and WCSPH slot solvers (models/dfsph_dense.py, models/wcsph_dense.py)
and, through their padded solvers, of the plane solvers
(models/dfsph_plane.py, models/wcsph_plane.py). It owns their common fields,
their pair route, their one pair pass (`_slot_pair`), the one-device hooks
that spatial sharding overrides (parallel/shard_dense.py,
parallel/shard_plane.py), and the host loop `simulate` (`HostLoop`, which
the table solvers of models/dfsph.py and models/wcsph.py share too).

The pair route is decided once, from the grid, by `pair_route`:

    use_pallas_slotmajor  K3 (ops/sm_pair_reduce.py), the forms in the JAX
                          slot-major closures' sum order, float32 only
                          (`require_float32_pairs`); its dead query slots
                          hold what the terms make of them
    otherwise             K5 (ops/pallas_pair.py), the forms in the JAX XLA
                          closures' order, K5's halo form under sharding;
                          on a pair_dtype "bfloat16" grid in K5's bf16 math
                          mode (consts and forms through `bf16_consts` and
                          `bf16_form`, positions rebased on the shard's
                          global cell rows); +0.0 at dead query slots

The plane solvers build their forms in the slot-major order and run them on
K1, whose bf16 operand mode follows the grid (ops/planes.plane_geom).
"""

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import pallas_pair, sm_pair_reduce
from ..ops.dense_grid import DenseGridConfig, require_float32_pairs, sort_by_dense_keys
from ..ops.pallas_pair import Rebase, bf16_consts, bf16_form, rebase_of
from ..ops.pair_reduce import PairForm
from ..timemanager import StepConfig
from ..units import REAL_NP
from ..utils.diagnostics import Diagnostics
from ..utils.profiling import read_back
from ..world import FluidProperties
from .viscosity import ViscosityModel, kernel_coefficient


class PairRoute(NamedTuple):
    """How a solver's pair passes run (module docstring)."""

    reduce: Callable  # sm_pair_reduce (K3) or pallas_pair_reduce (K5 and its halo form)
    slot_major: bool  # the forms' sum order: the JAX slot-major closures' (K3) or XLA's
    rebase: Optional[Rebase]  # K5's bf16 math mode on the grid's global rows; None: f32
    dead_zero: bool  # `reduce` writes +0.0 at dead query slots (K5)
    # the same kernel's gated launches of a DFSPH pressure loop (`loop_launcher`)
    loop_launcher: Callable


def pair_route(grid: DenseGridConfig, row0: int = 0) -> PairRoute:
    """The route of `grid`'s pair passes; `row0` is the first global cell row
    of a shard's grid (0 on one device)."""
    if grid.use_pallas_slotmajor:
        return PairRoute(sm_pair_reduce.sm_pair_reduce, True, None, False,
                         sm_pair_reduce.loop_launcher)
    return PairRoute(pallas_pair.pallas_pair_reduce, False, rebase_of(grid, row0), True,
                     pallas_pair.loop_launcher)


class HostLoop:
    """The solvers' host loop over their `step`."""

    # a rebuild every k-th step only: the DFSPH slot solvers' field (the JAX
    # package's opt-in stale steps); every other solver rebuilds every step
    rebuild_every = 1

    def simulate(self, carry, boundary, num_steps: int):
        """Run `num_steps` steps; the returned Diagnostics aggregates all of them
        (Diagnostics.accumulate). Each step's dt is accounted before it runs.
        With `rebuild_every` = k > 1 the steps run in blocks of one rebuilding
        step and k - 1 stale ones; the num_steps % k leftover steps rebuild
        (JAX dfsph_dense.py simulate)."""
        k = max(int(self.rebuild_every), 1)
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


@dataclass(frozen=True)
class SlotSolver(HostLoop):
    """The base of the slot-layout solvers. A subclass sets its smoothing
    kernels before calling this `__post_init__`, and gives its pair
    constants (`_make_consts`) and call forms (`_make_forms`, a NamedTuple
    of PairForms in the route's sum order); they are kept as `_consts` and
    `_forms`, in K5's bf16 math mode where the route has one."""

    viscosity_model: ViscosityModel
    properties: FluidProperties
    grid: DenseGridConfig
    step_config: StepConfig

    # K3 takes float32 only (K5 takes bf16 as its math mode); the plane
    # solvers' K1 takes bf16 operands
    _bf16_operands = False

    def __post_init__(self):
        if not self._bf16_operands:
            require_float32_pairs(self.grid, type(self).__name__)
        assert abs(self.grid.cell_size - self.properties.smoothing_length) < 1e-12
        m = float(self.properties.particle_mass)
        visc_suffix, visc_consts = kernel_coefficient(self.viscosity_model, m)
        route = pair_route(self.grid, self._rebucket_row0())
        object.__setattr__(self, "_visc_suffix", visc_suffix)
        object.__setattr__(self, "_route", route)
        consts, forms = self._make_consts(m, visc_consts), self._make_forms(m, route)
        if route.rebase is not None:
            consts = bf16_consts(consts)
            forms = type(forms)(*(bf16_form(f, consts) for f in forms))
        object.__setattr__(self, "_consts", consts)
        object.__setattr__(self, "_forms", forms)

    # --- one-device hooks; the shard solvers (parallel/shard_dense.py,
    # --- parallel/shard_plane.py) exchange and reduce them over the shards

    def _sort(self, tensors, positions, alive):
        """Init-time cell sort of per-particle tensors (sort_by_dense_keys);
        a shard sorts on its band of rows."""
        return sort_by_dense_keys(tensors, positions, self.grid, alive)

    def _sum_counts(self, count: torch.Tensor) -> torch.Tensor:
        """Sum of a per-shard counter (drops) or total (a residual's) over the
        shards: the count itself on one device."""
        return count

    def _local_sums(self) -> bool:
        """Whether `_sum_counts` is the identity (one device): a residual's
        total is then this device's own, and the DFSPH pressure loops may
        test it on the device (models/dfsph_dense.py)."""
        return True

    def _count_live(self, mask: torch.Tensor) -> np.float32:
        """Live-particle count, the residual-average denominator (the reference
        averages over its exact particle count, dfsph.rs:221, 376-377)."""
        return REAL_NP(read_back("live_count", mask.sum()))

    def _rebucket_row0(self) -> int:
        """This shard's first global cell row: 0 on one device."""
        return 0

    def _halo(self, tensors):
        """The neighbour shards' rows -1 and ny of `tensors` as a Halo, under
        spatial sharding; None on one device (the kernels' one-device forms)."""
        return None

    def _max_vel_from_sq(self, v_est_sq) -> np.float32:
        """CFL velocity from the live slots' squared speeds (dead slots 0)."""
        return REAL_NP(read_back("max_velocity", torch.sqrt(v_est_sq.max())))

    def _slot_pair(self, form: PairForm, q_pos, q_mask, s_pos, s_mask, s_halo=None,
                   q_vals=(), s_vals=(), scalars=()):
        """One pass on the route's kernel. A source with a halo (its positions'
        and mask's rows from the neighbour shards) takes its values' rows from
        them too, one exchange per pass, and runs K5's halo form."""
        route = self._route
        kw = dict(q_vals=q_vals, s_vals=s_vals, scalars=scalars)
        if route.rebase is not None:
            kw["rebase"] = route.rebase
        if s_halo is not None:
            rows = self._halo(s_vals).planes if s_vals else ()
            kw["halo"] = s_halo._replace(planes=s_halo.planes + tuple(rows))
        return route.reduce(form, q_pos, q_mask, s_pos, s_mask, self._consts, **kw)
