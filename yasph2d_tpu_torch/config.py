"""Declarative simulation configuration (PyTorch port of yasph2d_tpu/config.py).

The same dataclass tree, field names, defaults and JSON as the JAX package's
`SimulationConfig`, so that a file written by either package loads in the
other; the same scene ops and `default_scene()`. `build(device="cuda")`
returns a ready-to-run (world, solver, boundary, carry) quadruple for every
solver kind of the JAX package:

    dfsph          DFSPHSolver: neighbour tables, plain tensor operations
                   (the JAX app's default solver)
    wcsph          WCSPHSolver: neighbour tables
    dfsph_dense    DFSPHDenseSolver: the sorted carry, K3 with
                   `use_pallas_slotmajor`, K5 without
    wcsph_dense    WCSPHDenseSolver: the sorted carry, K3 or K5
    dfsph_padded   DFSPHPaddedSolver: K3 + K4 with `use_pallas_slotmajor`,
                   K5 + K4 without (the default kind)
    dfsph_plane    DFSPHPlaneSolver: K1 + K2 (f32 or bf16 operands)
    wcsph_padded   WCSPHPaddedSolver: K3 or K5, + K4
    wcsph_plane    WCSPHPlaneSolver: K1 + K2

The table kinds step on `world.grid` against `world.boundary_grid()`; the
dense knobs (`dense_*`, `use_pallas_slotmajor`, `pair_dtype`) do not reach
them, and the JAX table solver has no `rebuild_every`. An unknown kind
raises a ValueError. `pair_dtype="bfloat16"` runs K1's bf16 operands on the
plane kinds and K5's bf16 math mode on the padded and sorted kinds; with
`use_pallas_slotmajor` (K3) it raises, as the JAX slot-major solvers assert.
There is no CPU fallback:
`device="cuda"` without a card raises; `device="cpu"` runs the kernels'
plain twins.

Every `SolverConfig` field is either wired to the port's solver
(`WIRED_SOLVER_FIELDS`) or one of the TPU layout knobs
(`TPU_LAYOUT_KNOBS`: `pallas_pf_chunk_lanes`, `pallas_pf_stat_chunk_lanes`,
`pallas_pf_rebucket_chunk_lanes`, `pallas_pf_unroll`, `pallas_sm_row_block`),
which size the TPU kernels' lane chunks, unrolling and row bands and have no
meaning in the port's layout: they load, save and are ignored. The DFSPH
tolerances reach the DFSPH kinds and `rebuild_every` the DFSPH slot kinds, the WCSPH
compressibility and boundary force the WCSPH kinds (as in the JAX package,
`rebuild_every` has no WCSPH counterpart). No knob is dropped on the way to
the grid (the JAX `_grid_knobs` drops two of its own).
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import torch

from .world import FluidParticleWorld


# --------------------------------------------------------------------- scene ops


@dataclass(frozen=True)
class FluidRect:
    """fluid_world.add_fluid_rect (fluidparticleworld.rs:140-166)."""

    rect: Tuple[float, float, float, float]
    jitter: float = 0.05
    op: str = "fluid_rect"


@dataclass(frozen=True)
class BoundaryLine:
    """fluid_world.add_boundary_line (fluidparticleworld.rs:181-195)."""

    start: Tuple[float, float]
    end: Tuple[float, float]
    op: str = "boundary_line"


@dataclass(frozen=True)
class BoundaryThickLine:
    """fluid_world.add_boundary_thick_line (fluidparticleworld.rs:168-176)."""

    start: Tuple[float, float]
    end: Tuple[float, float]
    thickness: int = 2
    op: str = "boundary_thick_line"


_SCENE_OPS = {
    "fluid_rect": FluidRect,
    "boundary_line": BoundaryLine,
    "boundary_thick_line": BoundaryThickLine,
}

SceneOp = Union[FluidRect, BoundaryLine, BoundaryThickLine]


def default_scene() -> List[SceneOp]:
    """The reference's dam-break tank (main.rs:177-196)."""
    return [
        FluidRect(rect=(0.1, 0.7, 0.5, 1.0), jitter=0.05),
        BoundaryThickLine(start=(0.0, 2.5), end=(2.0, 2.5), thickness=4),
        BoundaryThickLine(start=(0.0, 0.0), end=(2.0, 0.0), thickness=4),
        BoundaryThickLine(start=(0.0, 0.0), end=(0.0, 2.5), thickness=4),
        BoundaryThickLine(start=(2.0, 0.0), end=(2.0, 2.5), thickness=4),
        BoundaryThickLine(start=(0.0, 0.6), end=(1.75, 0.5), thickness=2),
        BoundaryThickLine(start=(0.0, 2.5), end=(2.0, 2.5), thickness=2),
        BoundaryThickLine(start=(-2.0, -0.5), end=(4.0, -0.5), thickness=4),
    ]


# ------------------------------------------------------------------ components


@dataclass(frozen=True)
class FluidConfig:
    """ConstantFluidProperties args (main.rs:85-89 defaults)."""

    smoothing_factor: float = 2.0
    particle_density: float = 10000.0
    fluid_density: float = 100.0


@dataclass(frozen=True)
class ViscosityConfig:
    """XSPH (main.rs:93, xsph.rs:14) or physical (physical.rs:14, main.rs:95-96)."""

    kind: str = "xsph"  # "xsph" | "physical"
    xsph_epsilon: float = 0.05
    fluid_viscosity: float = 1.0016e-3  # Pa*s, water at 20C


@dataclass(frozen=True)
class TimestepConfig:
    """SimulationStepConfig (timemanager.rs:38-59; defaults main.rs:115-129).

    `cfl_factor` None -> solver-specific default (0.2 WCSPH / 1.5 DFSPH)."""

    kind: str = "adaptive"  # "adaptive" | "fixed"
    fixed_timestep: float = 1.0 / 3000.0
    timestep_max: float = 1.0 / 120.0 / 3.0
    timestep_min: float = 1.0 / 60.0 / 400.0
    cfl_factor: Optional[float] = None
    target_frame_length: Optional[float] = None


@dataclass(frozen=True)
class SolverConfig:
    """Solver selection and solver knobs (the JAX schema; module docstring
    for which kinds and knobs the port runs)."""

    kind: str = "dfsph_padded"
    max_avg_density_error: float = 0.01 / 100.0
    max_density_iterations: int = 200
    max_divergence_error: float = 0.1 / 100.0
    max_divergence_iterations: int = 400
    boundary_force_factor: float = 1.0
    target_density_variation: float = 0.01
    expected_max_flow_speed: float = 1.0
    dense_occupancy: int = 8
    # None: fit the boundary slot axis to its exact max cell occupancy
    dense_boundary_occupancy: Optional[int] = None
    dense_ny_multiple: int = 1
    # k-step neighbour rebuild (DFSPH kinds): 1 rebuilds every step, as the
    # reference does; k > 1 is the opt-in stale-step mode
    rebuild_every: int = 1
    # padded kinds: pair passes on K3 (True) or K5 (False); plane kinds set it
    use_pallas_slotmajor: bool = False
    # "float32" | "bfloat16" (plane kinds: K1's bf16 operands; padded kinds:
    # K5's bf16 math mode, refused on K3)
    pair_dtype: str = "float32"
    # TPU layout knobs (TPU_LAYOUT_KNOBS): no meaning in the port's layout
    pallas_pf_chunk_lanes: Optional[int] = None
    pallas_pf_stat_chunk_lanes: Optional[int] = -1
    pallas_pf_rebucket_chunk_lanes: Optional[int] = -1
    pallas_pf_unroll: Union[bool, str] = "auto"
    pallas_sm_row_block: int = 8


# the SolverConfig fields that reach the port's solvers, and the TPU layout
# knobs that have no meaning there; every field is in exactly one
WIRED_SOLVER_FIELDS = frozenset({
    "kind", "max_avg_density_error", "max_density_iterations", "max_divergence_error",
    "max_divergence_iterations", "boundary_force_factor", "target_density_variation",
    "expected_max_flow_speed", "dense_occupancy", "dense_boundary_occupancy",
    "dense_ny_multiple", "rebuild_every", "use_pallas_slotmajor", "pair_dtype",
})
TPU_LAYOUT_KNOBS = frozenset({
    "pallas_pf_chunk_lanes", "pallas_pf_stat_chunk_lanes",
    "pallas_pf_rebucket_chunk_lanes", "pallas_pf_unroll", "pallas_sm_row_block",
})

# the solver kinds: (class name, layout); "table" steps on the world's
# GridConfig and boundary_grid(), "dense" and "plane" on its dense grid and
# boundary_dense() (the plane solvers on its plane form)
KINDS = {
    "dfsph": ("DFSPHSolver", "table"),
    "wcsph": ("WCSPHSolver", "table"),
    "dfsph_dense": ("DFSPHDenseSolver", "dense"),
    "wcsph_dense": ("WCSPHDenseSolver", "dense"),
    "dfsph_padded": ("DFSPHPaddedSolver", "dense"),
    "dfsph_plane": ("DFSPHPlaneSolver", "plane"),
    "wcsph_padded": ("WCSPHPaddedSolver", "dense"),
    "wcsph_plane": ("WCSPHPlaneSolver", "plane"),
}


def require_kind(kind: str):
    """Raise a ValueError unless `kind` is one of the solver kinds."""
    if kind not in KINDS:
        raise ValueError(f"unknown solver kind {kind!r}")


def build_solver(kind: str, world, **solver):
    """The solver of `kind` on `world`, with the keywords `solver` (a
    `grid`, the DenseGridConfig, for the slot kinds): the table kinds step on
    the world's GridConfig and take no `grid` and no `rebuild_every` (the JAX
    table solver has none)."""
    import yasph2d_tpu_torch as y

    require_kind(kind)
    cls_name, layout = KINDS[kind]
    if layout == "table":
        solver = dict(solver, grid=world.grid)
        solver.pop("rebuild_every", None)
    return getattr(y, cls_name)(**solver)


def solver_boundary(kind: str, world, solver, device, occupancy=None):
    """The boundary that `solver` (of `kind`) steps against, on `device`:
    the world's `boundary_grid` for the table kinds, its `boundary_dense` on
    the solver's grid (`occupancy` slots a cell, None to fit) for the others,
    in plane form for the plane kinds."""
    layout = KINDS[kind][1]
    if layout == "table":
        return world.boundary_grid(device=device)
    boundary = world.boundary_dense(solver.grid, occupancy, device=device)
    return solver.boundary_planes(boundary) if layout == "plane" else boundary


def require_device(device, what: str) -> torch.device:
    """`device` as a torch.device; raises if it is a CUDA device and no card
    is present (no CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device 'cuda' asked for and no CUDA device is "
                           "available (pass device='cpu' for the twins)")
    return device


@dataclass(frozen=True)
class SimulationConfig:
    fluid: FluidConfig = field(default_factory=FluidConfig)
    viscosity: ViscosityConfig = field(default_factory=ViscosityConfig)
    timestep: TimestepConfig = field(default_factory=TimestepConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    scene: List[SceneOp] = field(default_factory=default_scene)
    gravity: Tuple[float, float] = (0.0, -9.81)

    # ------------------------------------------------------------ serialization

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimulationConfig":
        def build(klass, sub):
            fields = {f.name for f in dataclasses.fields(klass)}
            unknown = set(sub) - fields
            if unknown:
                raise ValueError(f"unknown {klass.__name__} keys: {sorted(unknown)}")
            return klass(**{
                k: tuple(v) if isinstance(v, list) and k in
                ("rect", "start", "end", "gravity") else v
                for k, v in sub.items()
            })

        scene = [
            build(_SCENE_OPS[op.get("op", "fluid_rect")], op)
            for op in d.get("scene", [])
        ] or default_scene()
        return cls(
            fluid=build(FluidConfig, d.get("fluid", {})),
            viscosity=build(ViscosityConfig, d.get("viscosity", {})),
            timestep=build(TimestepConfig, d.get("timestep", {})),
            solver=build(SolverConfig, d.get("solver", {})),
            scene=scene,
            gravity=tuple(d.get("gravity", (0.0, -9.81))),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "SimulationConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------------ factory

    def build_world(self) -> FluidParticleWorld:
        world = FluidParticleWorld(
            self.fluid.smoothing_factor,
            self.fluid.particle_density,
            self.fluid.fluid_density,
        )
        for op in self.scene:
            if isinstance(op, FluidRect):
                world.add_fluid_rect(op.rect, op.jitter)
            elif isinstance(op, BoundaryLine):
                world.add_boundary_line(op.start, op.end)
            elif isinstance(op, BoundaryThickLine):
                world.add_boundary_thick_line(op.start, op.end, op.thickness)
            else:  # pragma: no cover
                raise TypeError(f"unknown scene op {op!r}")
        return world

    def viscosity_model(self, smoothing_length: float):
        from .models.viscosity import PhysicalViscosityModel, XSPHViscosityModel

        v = self.viscosity
        if v.kind == "xsph":
            return XSPHViscosityModel(smoothing_length=smoothing_length,
                                      epsilon=v.xsph_epsilon)
        if v.kind == "physical":
            return PhysicalViscosityModel(smoothing_length=smoothing_length,
                                          fluid_viscosity=v.fluid_viscosity)
        raise ValueError(f"unknown viscosity kind {v.kind!r}")

    def step_config(self):
        from .timemanager import AdaptiveTimeStep, FixedTimeStep

        t = self.timestep
        if t.kind == "fixed":
            return FixedTimeStep(t.fixed_timestep)
        if t.kind == "adaptive":
            cfl_default = 0.2 if self.solver.kind.startswith("wcsph") else 1.5  # main.rs:115-118
            return AdaptiveTimeStep(
                timestep_max=t.timestep_max,
                timestep_min=t.timestep_min,
                cfl_factor=t.cfl_factor if t.cfl_factor is not None else cfl_default,
                target_frame_length=t.target_frame_length,
            )
        raise ValueError(f"unknown timestep kind {t.kind!r}")

    def build(self, device="cuda"):
        """(world, solver, boundary, carry) ready to step on `device`; the
        table kinds' boundary is the world's `boundary_grid`, the plane
        kinds' in plane form."""
        sc = self.solver
        require_kind(sc.kind)
        device = require_device(device, "SimulationConfig.build")
        world = self.build_world()
        grid = dataclasses.replace(
            world.dense_grid(occupancy=sc.dense_occupancy, ny_multiple=sc.dense_ny_multiple),
            use_pallas_slotmajor=sc.use_pallas_slotmajor or KINDS[sc.kind][1] == "plane",
            pair_dtype=sc.pair_dtype,
        )
        common = dict(
            viscosity_model=self.viscosity_model(world.properties.smoothing_length),
            properties=world.properties, grid=grid, step_config=self.step_config(),
            gravity=tuple(self.gravity),
        )
        if sc.kind.startswith("wcsph"):
            knobs = dict(boundary_force_factor=sc.boundary_force_factor,
                         target_density_variation=sc.target_density_variation,
                         expected_max_flow_speed=sc.expected_max_flow_speed)
        else:
            knobs = dict(max_avg_density_error=sc.max_avg_density_error,
                         max_density_iterations=sc.max_density_iterations,
                         max_divergence_error=sc.max_divergence_error,
                         max_divergence_iterations=sc.max_divergence_iterations,
                         rebuild_every=sc.rebuild_every)
        solver = build_solver(sc.kind, world, **common, **knobs)
        boundary = solver_boundary(sc.kind, world, solver, device, sc.dense_boundary_occupancy)
        carry = solver.init_carry(world.initial_state(device=device), boundary)
        return world, solver, boundary, carry
