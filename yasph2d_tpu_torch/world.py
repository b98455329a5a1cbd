"""Particle world: fluid constants, particle state and scene construction
(PyTorch port of yasph2d_tpu/world.py; reference: src/sph/fluidparticleworld.rs).

Scene construction is host numpy, copied from the JAX package line for line so
that both packages start from bit-identical particle positions (the seeded
jitter included). Device tensors are made only by `initial_state`,
`boundary_dense` and `boundary_grid`, on the card by default and on the CPU
when they are given `device="cpu"`; on a host without CUDA the default fails
as torch fails.

The table solvers' device functions are here too, as in the JAX package:
`sort_particles` and `update_neighborhood` (the cell-key sort of every
per-particle tensor and the neighbour tables of ops/neighborhood.py),
`update_densities` (the density summation over the tables) and
`pad_particles_dense` (dead padding particles for the dense grids).
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .ops import pair
from .ops.neighborhood import (
    CellGrid,
    GridConfig,
    Neighborhood,
    build_cell_grid,
    build_neighborhood,
    sort_by_cell_keys,
)
from .ops.smoothing_kernels import SmoothingKernel
from .ops.dense_grid import f32_scalar
from .units import REAL

GRAVITY = (0.0, -9.81)  # reference: fluidparticleworld.rs:123


@dataclass(frozen=True)
class FluidProperties:
    """Constant fluid properties (reference: fluidparticleworld.rs:46-90)."""

    smoothing_factor: float
    particle_density: float  # particles / m^2 for the resting fluid
    fluid_density: float  # kg / m^2 for the resting fluid (rho0)

    @property
    def particle_radius(self) -> float:
        # fluidparticleworld.rs:82-85: density is per m^2
        return 0.5 / float(np.sqrt(self.particle_density))

    @property
    def smoothing_length(self) -> float:
        # fluidparticleworld.rs:58: h = 2 * r * smoothing_factor
        return 2.0 * self.particle_radius * self.smoothing_factor

    @property
    def particle_mass(self) -> float:
        # fluidparticleworld.rs:74-76
        return self.fluid_density / self.particle_density

    @property
    def num_particles_per_meter(self) -> float:
        return float(np.sqrt(self.particle_density))


class ParticleState(NamedTuple):
    """Dynamic (fluid) particle state; `alive` marks real particles."""

    positions: torch.Tensor  # (N, 2) f32
    velocities: torch.Tensor  # (N, 2) f32
    densities: torch.Tensor  # (N,) f32
    alive: torch.Tensor  # (N,) bool


def _tree_map(fn, tree):
    """`fn` on every tensor of a tensor, or of a (named) tuple of them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    items = [_tree_map(fn, t) for t in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def pad_particles_dense(state: ParticleState, multiple: int, grid) -> ParticleState:
    """`state` padded with dead particles (alive False) so that N divides
    `multiple` (a device count), for the dense grids, whose cell keys send
    dead particles out of every cell. They are parked, zero velocity and
    density, a half cell above the grid's origin row (cosmetic: they never
    enter the grid). `grid` is a DenseGridConfig."""
    n = state.positions.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return state
    h = grid.cell_size
    xs = grid.origin[0] + (0.5 + np.arange(pad, dtype=np.float32) % grid.nx) * h
    ys = np.full((pad,), grid.origin[1] + 0.5 * h, dtype=np.float32)
    device = state.positions.device
    park = torch.as_tensor(np.stack([xs, ys], axis=-1), dtype=REAL, device=device)
    return ParticleState(
        positions=torch.cat([state.positions, park]),
        velocities=torch.cat([state.velocities, state.velocities.new_zeros((pad, 2))]),
        densities=torch.cat([state.densities, state.densities.new_zeros((pad,))]),
        alive=torch.cat([state.alive, state.alive.new_zeros((pad,))]),
    )


def sort_particles(tree, positions: torch.Tensor, grid: GridConfig):
    """Sort every tensor of `tree` (a tensor or a (named) tuple of them) into
    cell order keyed on `positions` (reference: fluidparticleworld.rs:235-261:
    particle identity is not stable across steps, so per-particle state that
    persists must travel in `tree`). Returns (sorted tree, sorted keys, perm)."""
    sorted_keys, perm = sort_by_cell_keys(positions, grid)
    return _tree_map(lambda t: t[perm], tree), sorted_keys, perm


def update_densities(positions: torch.Tensor, neighborhood: Neighborhood,
                     boundary_positions: torch.Tensor, kernel: SmoothingKernel,
                     mass: float, fluid_density: float) -> torch.Tensor:
    """Density summation with the self-contribution and the rho >= rho0 clamp
    (reference: fluidparticleworld.rs:197-231), in the JAX operation order."""
    m = f32_scalar(mass)

    def contribution(source_positions, table):
        _, r_sq, r = pair.pair_geometry(positions,
                                        pair.gather(source_positions, table.idx))
        return pair.masked_sum(kernel.evaluate(r_sq, r), table.mask)

    zero = torch.zeros((), dtype=REAL, device=positions.device)
    density = kernel.evaluate(zero, zero) * m  # the self-contribution
    density = density + m * contribution(positions, neighborhood.dynamic)
    density = density + m * contribution(boundary_positions, neighborhood.static)
    # the clamp works around particle deficiency (fluidparticleworld.rs:227-229)
    return torch.clamp(density, min=fluid_density)


def update_neighborhood(tree, positions: torch.Tensor, boundary: CellGrid,
                        grid: GridConfig):
    """Sort `tree` into cell order and build both neighbour tables
    (reference: FluidParticleWorld::update_neighborhood_datastructure,
    fluidparticleworld.rs:235-261). Returns (sorted tree, sorted positions,
    neighborhood)."""
    sorted_tree, sorted_keys, perm = sort_particles(tree, positions, grid)
    sorted_positions = positions[perm]
    return sorted_tree, sorted_positions, build_neighborhood(
        sorted_positions, sorted_keys, boundary, grid)


class FluidParticleWorld:
    """Host-side scene owner (reference: fluidparticleworld.rs:92-262). `grid`
    is the table solvers' cell grid (cell size h by default)."""

    # Dynamic headroom over the scene's INITIAL max cell occupancy (see the JAX
    # twin: 7 = 1.75x the bench scenes' initial max of 4 kept 600-step runs
    # drop-free).
    DENSE_OCCUPANCY_HEADROOM = 1.75

    def __init__(self, smoothing_factor: float, particle_density: float,
                 fluid_density: float, grid: Optional[GridConfig] = None):
        self.properties = FluidProperties(
            smoothing_factor=smoothing_factor,
            particle_density=particle_density,
            fluid_density=fluid_density,
        )
        self.grid = grid or GridConfig(cell_size=self.properties.smoothing_length)
        if abs(self.grid.cell_size - self.properties.smoothing_length) >= 1e-12:
            raise ValueError("the grid's cell size must equal the smoothing length "
                             "(the search radius)")
        self._positions: list = []  # list of (n, 2) float32 chunks
        self._boundary: list = []
        self._boundary_grid = None  # boundary_grid's cache: (device, CellGrid)

    # ---------------------------------------------------------------- scene API

    def remove_all_fluid_particles(self):
        self._positions = []

    def remove_all_boundary_particles(self):
        self._boundary = []
        self._boundary_grid = None

    def add_fluid_rect(self, fluid_rect, jitter_amount: float):
        """Fill an axis-aligned rect (x, y, w, h) with a jittered particle lattice
        (reference: fluidparticleworld.rs:140-166): lattice density de-rated by
        0.9, jitter from an RNG seeded with the current particle count."""
        x, y, w, h = (float(v) for v in fluid_rect)
        num_per_meter = self.properties.num_particles_per_meter * 0.9
        nx = max(1, int(w * num_per_meter))
        ny = max(1, int(h * num_per_meter))

        seed = sum(c.shape[0] for c in self._positions)
        rng = np.random.default_rng(seed)

        step = min(w / nx, h / ny)
        jitter_factor = step * float(jitter_amount)
        gx, gy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
        lattice = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32) * step
        # jitter in [0.5, 1.0) * jitter_factor per axis (fluidparticleworld.rs:158)
        jitter = (rng.random((nx * ny, 2), dtype=np.float32) * 0.5 + 0.5) * jitter_factor
        self._positions.append(np.asarray([x, y], dtype=np.float32) + lattice + jitter)

    def add_boundary_line(self, start, end):
        """One row of static boundary particles from start to end
        (reference: fluidparticleworld.rs:177-195)."""
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        distance = float(np.linalg.norm(end - start))
        npm = self.properties.num_particles_per_meter
        count = max(1, int(np.ceil(distance * npm)))
        step = (end - start) / distance / npm
        offsets = np.arange(count, dtype=np.float64)[:, None] * step[None, :]
        self._boundary.append((start[None, :] + offsets).astype(np.float32))
        self._boundary_grid = None

    def add_boundary_thick_line(self, start, end, thickness_in_particles: int):
        """Parallel boundary lines forming a thick wall
        (reference: fluidparticleworld.rs:168-176)."""
        start = np.asarray(start, dtype=np.float64)
        end = np.asarray(end, dtype=np.float64)
        direction = end - start
        direction = direction / np.linalg.norm(direction)
        perpendicular = np.asarray([-direction[1], direction[0]])
        thickness_world = thickness_in_particles / self.properties.num_particles_per_meter
        elongation = direction * thickness_world
        offset = -perpendicular * thickness_world
        step = perpendicular * thickness_world / thickness_in_particles
        for _ in range(thickness_in_particles):
            self.add_boundary_line(start + offset, end + offset + elongation)
            offset = offset + step

    # ------------------------------------------------------------- device state

    @property
    def num_dynamic_particles(self) -> int:
        return int(sum(c.shape[0] for c in self._positions))

    @property
    def num_boundary_particles(self) -> int:
        return int(sum(c.shape[0] for c in self._boundary))

    def host_positions(self) -> np.ndarray:
        if self._positions:
            return np.concatenate(self._positions, axis=0)
        return np.zeros((0, 2), dtype=np.float32)

    def host_boundary_positions(self) -> np.ndarray:
        if self._boundary:
            return np.concatenate(self._boundary, axis=0)
        return np.zeros((0, 2), dtype=np.float32)

    def initial_state(self, device="cuda") -> ParticleState:
        """Fluid state for the current scene (velocities and densities zero), on
        the card unless `device` says otherwise."""
        pos = torch.as_tensor(self.host_positions(), dtype=REAL, device=device)
        n = pos.shape[0]
        return ParticleState(
            positions=pos,
            velocities=torch.zeros((n, 2), dtype=REAL, device=device),
            densities=torch.zeros((n,), dtype=REAL, device=device),
            alive=torch.ones((n,), dtype=torch.bool, device=device),
        )

    def boundary_grid(self, device="cuda") -> CellGrid:
        """The boundary's sorted index space for the table solvers, on the card
        unless `device` says otherwise; built once and kept until the boundary
        or the device changes (reference: boundary_changed,
        fluidparticleworld.rs:101, 247-252)."""
        device = str(device)
        if self._boundary_grid is None or self._boundary_grid[0] != device:
            boundary = torch.as_tensor(self.host_boundary_positions(), dtype=REAL,
                                       device=device)
            self._boundary_grid = (device, build_cell_grid(boundary, self.grid))
        return self._boundary_grid[1]

    def dense_grid(self, occupancy: Optional[int] = None, margin_cells: int = 2,
                   ny_multiple: int = 1):
        """DenseGridConfig covering the scene's bounding box (fluid + boundary)
        with a margin; `occupancy=None` sizes the slot count from the initial
        packing times DENSE_OCCUPANCY_HEADROOM."""
        from .ops.dense_grid import DenseGridConfig

        fluid = self.host_positions()
        pts = [fluid, self.host_boundary_positions()]
        pts = np.concatenate([p for p in pts if p.shape[0]], axis=0)
        assert pts.shape[0] > 0, "empty scene"
        h = self.properties.smoothing_length
        lo = np.floor(pts.min(axis=0) / h) - margin_cells
        hi = np.ceil(pts.max(axis=0) / h) + margin_cells
        nx = int(hi[0] - lo[0])
        ny = int(hi[1] - lo[1])
        ny += (-ny) % ny_multiple

        if occupancy is None:
            if fluid.shape[0]:
                cx = np.clip(
                    np.floor(fluid[:, 0] / h).astype(np.int64) - int(lo[0]),
                    0, nx - 1,
                )
                cy = np.clip(
                    np.floor(fluid[:, 1] / h).astype(np.int64) - int(lo[1]),
                    0, ny - 1,
                )
                initial_max = int(np.bincount(cy * nx + cx).max())
            else:
                initial_max = 1
            occupancy = max(
                int(np.ceil(initial_max * self.DENSE_OCCUPANCY_HEADROOM)), 4
            )

        return DenseGridConfig(
            cell_size=h,
            origin=(float(lo[0] * h), float(lo[1] * h)),
            nx=nx,
            ny=ny,
            occupancy=occupancy,
        )

    def boundary_dense(self, grid, occupancy=None, device="cuda"):
        """Dense-layout static index space, on the card unless `device` says
        otherwise; None sizes the slot axis to the boundary's exact max cell
        occupancy."""
        from .models.dfsph_dense import build_boundary_dense

        boundary = torch.as_tensor(
            self.host_boundary_positions(), dtype=REAL, device=device
        )
        return build_boundary_dense(boundary, grid, occupancy)
