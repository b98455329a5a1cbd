"""The one scene generator: a scene file (`scenes/<scene>.json`) of fluid
rects and boundary lines, scaled to a target particle count and jittered
from the run's seed.

This is a frozen copy of the scene rules of `yasph2d_tpu_torch/world.py`
(`add_fluid_rect`, `add_boundary_line`, `add_boundary_thick_line`,
`dense_grid`), which follow the upstream fluidparticleworld.rs:140-195: the
fluid lattice is de-rated by 0.9 a side and jittered by [0.5, 1.0) x
jitter x spacing an axis, the jitter drawn from a generator seeded with the
number of fluid particles already placed (upstream's rule; here a
`torch.Generator` on the run's device). The boundary has no random part and
is built on the host in float64, then rounded to float32, as upstream.

`--seed` orders the fluid particles (one permutation drawn on the device):
every seed gives the same particles, grid and boundary, so the same work,
in another order. A seed that changed the jitter would change the flow: on
the reference scene it moved the impact on the ramp by a step and the
pressure iterations of the measured segment by 12%.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

LATTICE_DERATE = 0.9  # fluidparticleworld.rs:146, per side
GRID_MARGIN_CELLS = 2  # world.dense_grid's margin


class Grid(NamedTuple):
    """The dense slot grid over the scene: cell size h, origin, cells, slots a
    cell."""

    cell_size: float
    origin: tuple
    nx: int
    ny: int
    occupancy: int


class Scene(NamedTuple):
    """A scene as both the program and the reference receive it."""

    fluid: torch.Tensor  # (N, 2) float32, on the run's device
    boundary: torch.Tensor  # (M, 2) float32, on the run's device
    smoothing_factor: float
    particle_density: float  # particles / m^2
    fluid_density: float  # rho0, kg / m^2
    grid: Grid

    @property
    def particle_radius(self) -> float:
        return 0.5 / float(np.sqrt(self.particle_density))

    @property
    def smoothing_length(self) -> float:
        return 2.0 * self.particle_radius * self.smoothing_factor

    @property
    def particle_mass(self) -> float:
        return self.fluid_density / self.particle_density


def particle_density(spec: dict, target_particles: int) -> float:
    """Particles / m^2 that fill the scene's fluid rects with ~target
    particles on the de-rated lattice."""
    area = sum(r["rect"][2] * r["rect"][3] for r in spec["fluid_rects"])
    return target_particles / (area * LATTICE_DERATE ** 2)


def _fluid_rect(rect, jitter_amount, per_meter, placed, device):
    x, y, w, h = (float(v) for v in rect)
    n_per_meter = per_meter * LATTICE_DERATE
    nx = max(1, int(w * n_per_meter))
    ny = max(1, int(h * n_per_meter))
    step = min(w / nx, h / ny)
    jitter_factor = step * float(jitter_amount)
    gy, gx = torch.meshgrid(torch.arange(ny, device=device), torch.arange(nx, device=device),
                            indexing="ij")
    lattice = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1).to(torch.float32) * step
    gen = torch.Generator(device=device)
    gen.manual_seed(placed)
    jitter = (torch.rand((nx * ny, 2), generator=gen, device=device) * 0.5 + 0.5) * jitter_factor
    origin = torch.tensor([x, y], dtype=torch.float32, device=device)
    return origin + lattice + jitter


def _boundary_line(start, end, per_meter):
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    distance = float(np.linalg.norm(end - start))
    count = max(1, int(np.ceil(distance * per_meter)))
    step = (end - start) / distance / per_meter
    offsets = np.arange(count, dtype=np.float64)[:, None] * step[None, :]
    return (start[None, :] + offsets).astype(np.float32)


def _boundary_thick_line(start, end, thickness, per_meter):
    start = np.asarray(start, dtype=np.float64)
    end = np.asarray(end, dtype=np.float64)
    direction = (end - start) / np.linalg.norm(end - start)
    perpendicular = np.asarray([-direction[1], direction[0]])
    thickness_world = thickness / per_meter
    elongation = direction * thickness_world
    offset = -perpendicular * thickness_world
    step = perpendicular * thickness_world / thickness
    lines = []
    for _ in range(thickness):
        lines.append(_boundary_line(start + offset, end + offset + elongation, per_meter))
        offset = offset + step
    return lines


def dense_grid(fluid: np.ndarray, boundary: np.ndarray, h: float, occupancy: int) -> Grid:
    """The grid over the fluid's and the boundary's bounding box, with a
    margin of GRID_MARGIN_CELLS cells (world.dense_grid)."""
    pts = np.concatenate([p for p in (fluid, boundary) if p.shape[0]], axis=0)
    lo = np.floor(pts.min(axis=0) / h) - GRID_MARGIN_CELLS
    hi = np.ceil(pts.max(axis=0) / h) + GRID_MARGIN_CELLS
    return Grid(cell_size=h, origin=(float(lo[0] * h), float(lo[1] * h)),
                nx=int(hi[0] - lo[0]), ny=int(hi[1] - lo[1]), occupancy=int(occupancy))


def build(spec: dict, target_particles: int, occupancy: int, seed: int,
          device) -> Scene:
    """The scene of `spec` at ~`target_particles` fluid particles, in the
    order that `seed` draws, on `device`."""
    density = particle_density(spec, target_particles)
    per_meter = float(np.sqrt(density))
    rects = []
    for r in spec["fluid_rects"]:
        rects.append(_fluid_rect(r["rect"], r["jitter"], per_meter,
                                 sum(x.shape[0] for x in rects), device))
    fluid = torch.cat(rects)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    fluid = fluid[torch.randperm(fluid.shape[0], generator=gen, device=device)]
    lines = []
    for b in spec["boundary_thick_lines"]:
        lines += _boundary_thick_line(b["start"], b["end"], int(b["thickness"]), per_meter)
    boundary = np.concatenate(lines, axis=0)
    scene = Scene(fluid=fluid, boundary=torch.as_tensor(boundary, device=device),
                  smoothing_factor=float(spec["smoothing_factor"]),
                  particle_density=density, fluid_density=float(spec["fluid_density"]),
                  grid=None)
    h = scene.smoothing_length
    lo = fluid.min(dim=0).values.cpu().numpy()
    hi = fluid.max(dim=0).values.cpu().numpy()
    grid = dense_grid(np.stack([lo, hi]), boundary, h, occupancy)
    if not (math.isfinite(h) and grid.nx > 0 and grid.ny > 0):
        raise ValueError(f"scene: no grid for h {h!r} ({grid.nx} x {grid.ny} cells)")
    return scene._replace(grid=grid)
