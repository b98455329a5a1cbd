"""The port's profiling helpers (yasph2d_tpu_torch/utils/profiling.py) on the CPU.

- `scope(group, name)` is a "group.name" range of `torch.profiler`: nested
  scopes around one step of the port's DFSPH padded solver, inside a
  `trace(log_dir, step_name)`, appear by name in the Chrome trace it writes,
  beside the step's own operations.
- `StepTimer` keeps the JAX package's bounded history, mean and last sample
  (yasph2d_tpu/utils/profiling.py StepTimer), checked against it.
"""

import json

import pytest

from yasph2d_tpu.utils.profiling import StepTimer as JStepTimer
from yasph2d_tpu_torch import (
    AdaptiveTimeStep,
    DFSPHPaddedSolver,
    FluidParticleWorld,
    XSPHViscosityModel,
)
from yasph2d_tpu_torch.utils import profiling
from yasph2d_tpu_torch.utils.profiling import StepTimer, scope, trace


def _small_padded():
    world = FluidParticleWorld(2.0, 2500.0, 100.0)
    world.add_fluid_rect((0.1, 0.1, 0.3, 0.3), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (0.6, 0.0), 2)
    h = world.properties.smoothing_length
    solver = DFSPHPaddedSolver(viscosity_model=XSPHViscosityModel(h),
                               properties=world.properties,
                               grid=world.dense_grid(occupancy=8),
                               step_config=AdaptiveTimeStep(1.0 / 360.0, 1.0 / 24000.0, 1.5))
    boundary = world.boundary_dense(solver.grid, device="cpu")
    carry = solver.init_carry(world.initial_state(device="cpu"), boundary)
    return solver, boundary, carry


def test_nested_scopes_in_trace(tmp_path):
    solver, boundary, carry = _small_padded()
    with trace(str(tmp_path), step_name="frame0"):
        with scope("App", "simulate"):
            with scope("DFSPH", "step"):
                carry, diag = solver.simulate(carry, boundary, 1)
    assert int(carry.time.num_steps) == 1 and diag.neighbor_drops == 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events if e.get("ph") == "X"}
    for name in ("frame0", "App.simulate", "DFSPH.step"):
        assert name in spans, name
    # nested: each range lies within its parent on the host timeline
    for inner, outer in (("DFSPH.step", "App.simulate"), ("App.simulate", "frame0")):
        i, o = spans[inner], spans[outer]
        assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1
    # the step's own operations ran inside the scopes
    step = spans["DFSPH.step"]
    inside = [e for e in events if e.get("ph") == "X" and e["name"].startswith("aten::")
              and step["ts"] <= e["ts"] <= step["ts"] + step["dur"]]
    assert inside


def test_trace_without_step_name(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        with scope("Render", "rasterize"):
            sum(range(10))
    assert prof is not None
    names = {e["name"] for e in json.loads((tmp_path / "t" / "trace.json").read_text())
             ["traceEvents"]}
    assert "Render.rasterize" in names


def test_scope_outside_a_trace_is_a_plain_context():
    with scope("App", "idle") as s:
        pass
    assert s is not None


@pytest.mark.parametrize("samples", [[0.5, 0.25, 0.125], [1.0] * 7])
def test_step_timer_matches_jax(samples, monkeypatch):
    timers = []
    for cls in (JStepTimer, StepTimer):
        clock = iter(t for s in samples for t in (0.0, s))
        mod = profiling if cls is StepTimer else __import__(cls.__module__, fromlist=["x"])
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(clock))
        timer = cls(history_length=5)
        assert timer.mean == 0.0 and timer.last == 0.0
        for _ in samples:
            with timer:
                pass
        timers.append(timer)
        monkeypatch.undo()
    ref, port = timers
    assert list(port.history) == list(ref.history) == samples[-5:]
    assert port.mean == ref.mean and port.last == ref.last == samples[-1]
