"""The comparison that decides `correct`.

The window's own steps are judged: the harness keeps the program's carry
before and after each of a few consecutive steps of the window's first
replay (which ones is drawn from the seed), and after the window closes
the plain reference (`reference/`) runs each of those steps again from the
program's state before it: the live slots' positions, velocities and warm
starts (DFSPH) or cached accelerations (WCSPH), the current dt and the
previous iteration counts. Everything the step derives (pair context,
viscosity, CFL dt, pressure solves, advection, densities and forces) the
reference works out itself. The reference cannot follow the program over
the settle steps and the replays (the flow is chaotic at float32), so it
follows it step by step from the program's own state, and the start is
checked by itself: the initial carry's live slots must hold exactly the
scene's particles, at rest, with the reference's densities.

Particle identity does not survive the re-bucket, so each reference
particle is matched to the program's live slot nearest to it among the 3 x 3
cells of its position. The numbers (each a worst case over the compared
particles and steps):

- density: |rho - rho_ref| / rho0 of the pair context the step starts from
  (DFSPH: K5's ctx passes; WCSPH: the densities the step computes);
- alpha (DFSPH): |alpha - alpha_ref| / max |alpha_ref|;
- velocity, accel (WCSPH), kappa and stiffness (DFSPH, the warm starts the
  next step reads): |a - a_ref| / max |a_ref|, after the matching;
- position: the matched distance / h;
- dt: |dt - dt_ref| / dt_ref of the new step size;
- iterations (DFSPH): the largest difference of the density or the
  divergence solve's iteration count;
- drops: |program drops - reference drops|, the reference counting the
  particles beyond the grid's slots a cell;
- unmatched: reference particles without a slot of their own, and live
  slots matched by none or by several;
- misplaced: live slots whose cell is not the cell of their position,
  clamped into the grid as the program and the reference both clamp (1e-2
  of a cell allowed at a border: float32 cell coordinates of ~5000 cells
  are rounded to ~1e-3);
- gaps: live slots after a dead one in a cell (K4 fills a cell's slots
  0..n-1);
- start: initial live slots that differ from the scene's particles, or move;
- leaked: live fluid slots that have passed a wall: beyond the tank's
  walls (outside the scene's `tank` rect grown by the walls' thickness in
  particle spacings) or inside one of its `sealed` regions (the inside of
  the box obstacle, the space under the ramp), in the segment's start
  state, after each compared step and at the end of the window's last
  replay. A particle that falls through a wall gains speed without limit
  and sets the CFL dt of every later step.
"""

import math

import numpy as np
import torch

from .reference import Consts
from .reference import dfsph as ref_dfsph
from .reference import wcsph as ref_wcsph
from .reference.neighbors import cells

CELL_TOLERANCE = 1e-2  # of a cell: float32 cell coordinates near 5000 cells
BLOCK = 1 << 18  # reference particles matched at once


def live(state: dict, key: str) -> torch.Tensor:
    """The live slots' values of `key`, in slot order."""
    return state[key][state["mask"]]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| (vector norm over a trailing pair) / max |b|."""
    if a.ndim == 2:
        diff, scale = (a - b).norm(dim=-1), b.norm(dim=-1)
    else:
        diff, scale = (a - b).abs(), b.abs()
    top = float(scale.max()) if scale.numel() else 0.0
    return float(diff.max()) / top if top > 0 else float(diff.max()) if diff.numel() else 0.0


def match(x: torch.Tensor, state: dict, k: Consts):
    """(flat slot index, distance) of the program's live slot nearest each
    reference position `x` (N, 2) among the 3 x 3 cells around it; the
    distance is inf where none is live."""
    pos = state["pos"].reshape(-1, 2)
    mask = state["mask"].reshape(-1)
    p = state["mask"].shape[-1]
    lane = torch.arange(p, device=x.device)
    slots, dists = [], []
    for lo in range(0, x.shape[0], BLOCK):
        xb = x[lo:lo + BLOCK]
        cx, cy = cells(xb, k)
        cand = []
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ix, iy = cx + dx, cy + dy
                inside = (ix >= 0) & (ix < k.nx) & (iy >= 0) & (iy < k.ny)
                cell = torch.where(inside, iy * k.nx + ix, 0)
                s = cell[:, None] * p + lane[None, :]
                cand.append(torch.where(inside[:, None] & mask[s], s, -1))
        cand = torch.cat(cand, dim=1)
        d = (pos[cand.clamp(min=0)] - xb[:, None, :]).norm(dim=-1)
        d = torch.where(cand >= 0, d, float("inf"))
        best, at = d.min(dim=1)
        slots.append(cand.gather(1, at[:, None])[:, 0])
        dists.append(best)
    return torch.cat(slots), torch.cat(dists)


def unmatched(slot: torch.Tensor, dist: torch.Tensor, state: dict) -> int:
    mask = state["mask"].reshape(-1)
    counts = torch.bincount(slot.clamp(min=0), minlength=mask.numel())
    return int((~torch.isfinite(dist)).sum()) + int((counts[mask] != 1).sum()) + int(
        (counts[~mask] > 0).sum())


def misplaced(state: dict, k: Consts) -> int:
    """Live slots whose cell is not the (clamped) cell of their position,
    within CELL_TOLERANCE of a cell border, in float64."""
    mask, pos = state["mask"], state["pos"].double()
    ny, nx, _ = mask.shape
    device = pos.device
    out = torch.zeros_like(mask)
    for axis, n, index in ((0, nx, torch.arange(nx, device=device)[None, :, None]),
                           (1, ny, torch.arange(ny, device=device)[:, None, None])):
        u = (pos[..., axis] - k.origin[axis]) / k.h
        lo = torch.floor(u - CELL_TOLERANCE).clamp(0, n - 1)
        hi = torch.floor(u + CELL_TOLERANCE).clamp(0, n - 1)
        out |= (index < lo) | (index > hi)
    return int((out & mask).sum())


def gaps(state: dict) -> int:
    """Live slots after a dead slot of their cell (K4 fills 0..n-1)."""
    mask = state["mask"]
    return int((mask[..., 1:] & ~mask[..., :-1]).sum())


def leaked(state: dict, scene: dict, spacing: float) -> int:
    """Live slots beyond the walls of `scene["tank"]` (outside its rect, x0,
    y0, x1, y1, grown by its `walls` particle spacings) or inside a region of
    `scene["sealed"]` (a convex polygon, its corners counter-clockwise)."""
    x = live(state, "pos")
    x0, y0, x1, y1 = scene["tank"]["rect"]
    m = scene["tank"]["walls"] * spacing
    out = (x[:, 0] < x0 - m) | (x[:, 0] > x1 + m) | (x[:, 1] < y0 - m) | (x[:, 1] > y1 + m)
    for region in scene.get("sealed", ()):
        corner = torch.tensor(region["polygon"], dtype=x.dtype, device=x.device)
        edge = corner.roll(-1, 0) - corner
        rel = x[:, None, :] - corner[None]
        left = edge[None, :, 0] * rel[..., 1] - edge[None, :, 1] * rel[..., 0] > 0
        out |= left.all(dim=1)
    return int(out.sum())


def start_mismatch(fluid: torch.Tensor, init: dict) -> int:
    """Initial live slots that are not exactly the scene's particles at rest:
    both position sets sorted by (x, y) must be equal bit for bit."""
    x = init["pos"]
    if x.shape[0] != fluid.shape[0]:
        return abs(x.shape[0] - fluid.shape[0]) + fluid.shape[0]

    def lexsorted(a):
        a = a[torch.argsort(a[:, 1], stable=True)]
        return a[torch.argsort(a[:, 0], stable=True)]

    differ = (lexsorted(x) != lexsorted(fluid)).any(dim=1)
    return int(differ.sum()) + int((init["vel"] != 0).any(dim=1).sum())


def compact_init(state: dict) -> dict:
    """The live slots of the initial carry that the start check reads."""
    out = {key: live(state, key) for key in ("pos", "vel")}
    if "alpha" in state:
        out.update(density=live(state, "density"), alpha=live(state, "alpha"))
    return out


def check_start(fluid, boundary, init: dict, k: Consts, method: str) -> dict:
    nums = {"start": start_mismatch(fluid, init)}
    if method == "dfsph":
        c = ref_dfsph.context(init["pos"], boundary, k)
        nums["density"] = float((init["density"] - c.density).abs().max()) / k.rho0
        nums["alpha"] = _rel(init["alpha"], c.alpha)
    return nums


def check_step(before: dict, after: dict, step, boundary, k: Consts, method: str) -> dict:
    """The numbers of one step of the program (`before` -> `after`, its
    `step` record) against the reference's step from `before`."""
    x0, v0 = live(before, "pos"), live(before, "vel")
    if method == "dfsph":
        r = ref_dfsph.step(x0, v0, live(before, "kappa"), live(before, "stiff"),
                           np.float32(before["dt"]), before["prev_density_iterations"],
                           before["prev_divergence_iterations"], boundary, k)
    else:
        r = ref_wcsph.step(x0, v0, live(before, "accel"), np.float32(before["dt"]),
                           boundary, k)
    slot, dist = match(r["x"], after, k)
    ok = torch.isfinite(dist)
    take = slot.clamp(min=0)

    def at(key):
        flat = after[key].reshape(after["mask"].numel(), *after[key].shape[3:])
        return flat[take][ok]

    nums = {
        "velocity": _rel(at("vel"), r["v"][ok]),
        "position": float(dist.max()) / k.h if dist.numel() else 0.0,
        "dt": abs(float(after["dt"]) - float(r["dt"])) / float(r["dt"]),
        "drops": abs(int(step.drops) - int(r["drops"])),
        "unmatched": unmatched(slot, dist, after),
        "misplaced": misplaced(after, k),
        "gaps": gaps(after),
    }
    if method == "dfsph":
        nums.update(
            density=float((live(before, "density") - r["density_before"]).abs().max())
            / k.rho0,
            alpha=_rel(live(before, "alpha"), r["alpha_before"]),
            kappa=_rel(at("kappa"), r["kappa"][ok]),
            stiffness=_rel(at("stiff"), r["stiff"][ok]),
            iterations=max(abs(step.density_iterations - r["density_iterations"]),
                           abs(step.divergence_iterations - r["divergence_iterations"])))
    else:
        nums.update(density=float((at("density") - r["density"][ok]).abs().max()) / k.rho0,
                    accel=_rel(at("accel"), r["accel"][ok]))
    return nums


def worst(readings: list) -> dict:
    """The largest reading of each number over a list of readings."""
    out = {}
    for nums in readings:
        for key, value in nums.items():
            if key not in out or math.isnan(value) or value > out[key]:
                out[key] = value
    return out
