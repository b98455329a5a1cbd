"""The port's profiling helpers (yasph2d_tpu_torch/utils/profiling.py) on the CPU.

- `scope(group, name)` is a "group.name" range of `torch.profiler`: nested
  scopes around one step of the port's DFSPH padded solver, inside a
  `trace(log_dir, step_name)`, appear by name in the Chrome trace it writes,
  beside the step's own operations.
- `StepTimer` keeps the JAX package's bounded history, mean and last sample
  (yasph2d_tpu/utils/profiling.py StepTimer), checked against it.
- While no profiler records, `scope` enters no `record_function`;
  `read_back` is `.item()` counted in `READBACKS`. A padded step reads back
  2 numbers (WCSPH) or its pressure iterations + 3 (DFSPH), and opens its
  phase scopes in order inside its step scope.
- `tools/step_phases.attribute` puts each device operation and idle gap of a
  trace to the scope open at its launch or at the gap's start, and splits
  the pressure loops by their iterations and read-backs; with the steps'
  counts of timemanager.CLAMPS, the share of steps whose dt each bound set.
"""

import json

import pytest

import torch

from yasph2d_tpu.utils.profiling import StepTimer as JStepTimer
from yasph2d_tpu_torch import (
    AdaptiveTimeStep,
    DFSPHPaddedSolver,
    FluidParticleWorld,
    XSPHViscosityModel,
)
from yasph2d_tpu_torch import timemanager
from yasph2d_tpu_torch.scenes import bench_solver
from yasph2d_tpu_torch.tools import step_phases
from yasph2d_tpu_torch.utils import profiling
from yasph2d_tpu_torch.utils.profiling import StepTimer, read_back, scope, trace


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


def test_scope_enters_no_record_function_while_no_profiler_records(tmp_path, monkeypatch):
    calls = []
    enter = torch.ops.profiler._record_function_enter_new

    def counted(*args):
        calls.append(args[0])
        return enter(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    with scope("App", "idle"):
        pass
    assert calls == []
    with trace(str(tmp_path)):
        with scope("App", "busy"):
            pass
    assert calls == ["App.busy"]  # the patch sees the profiler's entries


@pytest.mark.parametrize("value", [torch.tensor(2.5), torch.tensor(7, dtype=torch.int32),
                                   torch.tensor(3, dtype=torch.int64).sum()])
def test_read_back_is_item_counted(value):
    before = profiling.READBACKS["probe"]
    got = read_back("probe", value)
    assert got == value.item() and type(got) is type(value.item())
    assert profiling.READBACKS["probe"] == before + 1


# the phase scopes of each padded step, in the order the step opens them
PHASES = {
    "wcsph_padded_k5": ("WCSPH", ["WCSPH.kick_drift", "K4.rebucket", "WCSPH.pairs",
                                  "WCSPH.cfl", "WCSPH.kick"]),
    "dfsph_padded_k5": ("DFSPH", ["DFSPH.viscosity", "DFSPH.cfl", "DFSPH.density_loop",
                                  "DFSPH.advect", "K4.rebucket", "DFSPH.context",
                                  "DFSPH.divergence_loop"]),
}


def _padded(kind):
    world = FluidParticleWorld(2.0, 2500.0, 100.0)
    world.add_fluid_rect((0.1, 0.1, 0.3, 0.3), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (0.6, 0.0), 2)
    solver, boundary = bench_solver(kind, world, device="cpu", occupancy=8)
    return solver, boundary, solver.init_carry(world.initial_state(device="cpu"), boundary)


@pytest.mark.parametrize("kind", list(PHASES))
def test_padded_step_read_backs(kind):
    solver, boundary, carry = _padded(kind)
    for _ in range(2):
        profiling.reset_readbacks()
        carry, diag = solver.simulate(carry, boundary, 1)
        expected = (2 if kind.startswith("wcsph")
                    else diag.density_iterations + diag.divergence_iterations + 3)
        assert sum(profiling.READBACKS.values()) == expected, dict(profiling.READBACKS)
    assert set(profiling.READBACKS) == (
        {"max_velocity", "drops"} if kind.startswith("wcsph")
        else {"live_count", "max_velocity", "mean_residual", "drops"})


@pytest.mark.parametrize("kind", list(PHASES))
def test_padded_step_scopes_in_trace(kind, tmp_path):
    group, phases = PHASES[kind]
    solver, boundary, carry = _padded(kind)
    before = sum(profiling.READBACKS.values())
    with trace(str(tmp_path)):
        carry, _ = solver.simulate(carry, boundary, 2)
    syncs = sum(profiling.READBACKS.values()) - before
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    steps = [s for s in spans if s[2] == f"{group}.step"]
    assert len(steps) == 2
    for t0, t1, _ in steps:
        inside = [s for s in spans if t0 <= s[0] and s[1] <= t1 and s[2] != f"{group}.step"]
        assert [s[2] for s in inside if not s[2].startswith("sync.")] == phases
    # every read-back opened its scope, inside a step
    sync = [s for s in spans if s[2].startswith("sync.")]
    assert len(sync) == syncs and all(any(a <= s[0] and s[1] <= b for a, b, _ in steps)
                                      for s in sync)
    assert step_phases.attribute(events)["split"]["syncs"] == syncs / 2


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts, op, start, dur, cat="kernel"):
    """A runtime call at `ts` and the device operation `op` it launched."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": op, "ts": start, "dur": dur,
             "args": {"correlation": corr}}]


def _synthetic_step():
    """One WCSPH step in microseconds: glue in kick_drift (a slot glue
    kernel), K4, K5 and glue in pairs, a read-back in cfl, glue in kick;
    then two operations launched outside any step scope."""
    return [
        _span("WCSPH.step", 0, 100), _span("WCSPH.kick_drift", 1, 9),
        _span("K4.rebucket", 10, 10), _span("WCSPH.pairs", 20, 30),
        _span("WCSPH.cfl", 50, 20), _span("sync.max_velocity", 60, 9),
        _span("WCSPH.kick", 70, 20),
        *_launch(1, 2, "slot_kick_drift_kernel(unsigned char const*, int)", 20, 5),
        *_launch(2, 11, "void sm_rebucket_staged<false>(SrKernelArgs<false>)", 25, 5),
        *_launch(3, 21, "void tile_pair_reduce_kernel<false, F32Math>(args)", 30, 10),
        *_launch(4, 22, "void at::vectorized_elementwise_kernel<4>(int)", 40, 2),
        # the pairs' glue ends at 42, the host launches the next at 60: 18 us
        *_launch(5, 60, "Memcpy DtoH (Device -> Pageable)", 60, 1, "gpu_memcpy"),
        # the read-back returns at 61, the next operation starts at 75: 14 us
        *_launch(6, 71, "void at::elementwise_kernel<128, 2>(int)", 75, 2),
        # launched after the step: the device idles from 77 (inside the kick
        # scope) to 102, and from 103 (outside every step scope) to 130
        *_launch(7, 101, "Memset (Device)", 102, 1, "gpu_memset"),
        *_launch(8, 129, "void at::elementwise_kernel<128, 2>(int)", 130, 1),
    ]


def test_step_phases_put_operations_and_gaps_to_scopes():
    got = step_phases.attribute(_synthetic_step())
    assert got["steps"] == 1
    rows = got["scopes"]
    assert list(rows) == ["WCSPH.kick_drift", "K4.rebucket", "WCSPH.pairs",
                          "sync.max_velocity", "WCSPH.kick", "(no scope)"]
    assert rows["WCSPH.pairs"] == {"device_ms": pytest.approx(0.012), "launches": 2,
                                   "glue_ms": pytest.approx(0.002), "glue_launches": 1,
                                   "idle_ms": pytest.approx(0.018)}
    assert rows["K4.rebucket"]["glue_launches"] == 0
    assert rows["sync.max_velocity"]["idle_ms"] == pytest.approx(0.014)
    assert rows["WCSPH.kick"]["idle_ms"] == pytest.approx(0.025)
    assert rows["(no scope)"]["idle_ms"] == pytest.approx(0.027)
    split = got["split"]
    assert split == {"pair_glue_ms": pytest.approx(0.002),
                     "integrate_glue_ms": pytest.approx(0.008),
                     "outside_glue_ms": pytest.approx(0.002),
                     "sync_idle_ms": pytest.approx(0.014),
                     "dispatch_idle_ms": pytest.approx(0.043),
                     "caller_idle_ms": pytest.approx(0.027), "syncs": 1.0,
                     "slot_glue_launches": 1.0}
    # the split's glue is every row's glue, and its idle every gap
    assert sum(r["glue_ms"] for r in rows.values()) == pytest.approx(0.012)
    assert sum(r["idle_ms"] for r in rows.values()) == pytest.approx(0.084)


def test_step_phases_without_a_step_scope():
    events = [e for e in _synthetic_step() if e["name"] != "WCSPH.step"]
    assert step_phases.attribute(events) == {"steps": 0, "scopes": {}, "split": None}


def _synthetic_dfsph_step():
    """One DFSPH step in microseconds: a density loop of two iterations and a
    divergence loop of one, each iteration a K5 pass, a glue operation (in
    the second density iteration a pressure glue kernel) and the read-back
    of its mean residual."""
    return [
        _span("DFSPH.step", 0, 200), _span("DFSPH.density_loop", 10, 100),
        _span("sync.mean_residual", 40, 10), _span("sync.mean_residual", 90, 10),
        _span("DFSPH.divergence_loop", 120, 60), _span("sync.mean_residual", 160, 10),
        # density iteration 1: K5 at 20-30, glue at 30-32, the copy at 40-41;
        # the device idles 32-40 behind the launches, 41-55 in the read-back
        *_launch(1, 11, "void tile_pair_reduce_kernel<false, F32Math>(args)", 20, 10),
        *_launch(2, 12, "void at::vectorized_elementwise_kernel<4>(int)", 30, 2),
        *_launch(3, 40, "Memcpy DtoH (Device -> Pageable)", 40, 1, "gpu_memcpy"),
        # density iteration 2: K5 at 55-65, glue at 65-69, the copy at 90-91;
        # idle 69-90 behind the launches, 91-130 in the read-back
        *_launch(4, 51, "void tile_pair_reduce_kernel<false, F32Math>(args)", 55, 10),
        *_launch(5, 52, "void slot_pressure_err_kernel<true>(unsigned char const*, int)", 65,
                 4),
        *_launch(6, 90, "Memcpy DtoH (Device -> Pageable)", 90, 1, "gpu_memcpy"),
        # divergence iteration: K5 at 130-150, the copy at 160-162
        *_launch(7, 121, "void tile_pair_reduce_kernel<false, F32Math>(args)", 130, 20),
        *_launch(8, 160, "Memcpy DtoH (Device -> Pageable)", 160, 2, "gpu_memcpy"),
        *_launch(9, 185, "void at::elementwise_kernel<128, 2>(int)", 190, 1),
    ]


def test_step_phases_split_each_pressure_loop_by_its_iterations():
    loops = step_phases.attribute(_synthetic_dfsph_step())["loops"]
    assert list(loops) == ["DFSPH.density_loop", "DFSPH.divergence_loop"]
    assert loops["DFSPH.density_loop"] == {
        "iterations": 2.0, "readbacks": 2.0, "overshoot": None,
        "device_ms": pytest.approx(0.014),
        "glue_ms": pytest.approx(0.004), "idle_ms": pytest.approx((8 + 14 + 21 + 39) / 2e3),
        "glue_launches": 2.0, "slot_glue_launches": 0.5}
    # idle behind its launch 150-160, and in its read-back from 162 until
    # the next operation at 190
    assert loops["DFSPH.divergence_loop"] == {
        "iterations": 1.0, "readbacks": 1.0, "overshoot": None,
        "device_ms": pytest.approx(0.022),
        "glue_ms": pytest.approx(0.002), "idle_ms": pytest.approx(0.038),
        "glue_launches": 1.0, "slot_glue_launches": 0.0}


def test_step_phases_count_a_loop_tested_on_the_device():
    """Where the device tests a loop's exit, the loop reads its state back
    once a chunk ("sync.loop_state"), and the iteration counts the trace
    carries (ops/pressure_glue.py ITERATIONS) give its iterations and the
    share of enqueued iterations gated off."""
    events = [dict(e, name="sync.loop_state") if e["name"] == "sync.mean_residual" else e
              for e in _synthetic_dfsph_step()]
    counts = {"density_enqueued": 4, "density_run": 3, "divergence_enqueued": 2,
              "divergence_run": 1}
    loops = step_phases.attribute(events, counts)["loops"]
    density, divergence = loops["DFSPH.density_loop"], loops["DFSPH.divergence_loop"]
    assert (density["iterations"], density["readbacks"], density["overshoot"]) == (3, 2, 0.25)
    assert density["device_ms"] == pytest.approx(0.028 / 3)
    assert (divergence["iterations"], divergence["readbacks"], divergence["overshoot"]) == (
        1, 1, 0.5)
    # without the counts, a device-tested loop's iterations are unknown
    assert step_phases.attribute(events)["loops"]["DFSPH.density_loop"]["device_ms"] is None


def test_step_phases_count_the_loop_iterations_of_a_real_trace(tmp_path):
    """The "sync.mean_residual" scopes inside each loop are the Diagnostics'
    iterations, two steps of the padded DFSPH step in a CPU trace."""
    solver, boundary, carry = _padded("dfsph_padded_k5")
    its = {"DFSPH.density_loop": 0, "DFSPH.divergence_loop": 0}
    with trace(str(tmp_path)):
        for _ in range(2):
            carry, diag = solver.simulate(carry, boundary, 1)
            its["DFSPH.density_loop"] += diag.density_iterations
            its["DFSPH.divergence_loop"] += diag.divergence_iterations
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    loops = step_phases.attribute(events)["loops"]
    assert {name: loop["iterations"] * 2 for name, loop in loops.items()} == its


def test_step_phases_give_the_share_of_steps_on_each_dt_bound(tmp_path, capsys):
    """A trace that tools/trace_step.py wrote carries the steps by the bound
    that set their dt (timemanager.CLAMPS, key "clamps"): each bound's share
    of the steps; None without the counts."""
    assert step_phases.attribute(_synthetic_step())["dt_bounds"] is None
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _synthetic_step(),
                                "clamps": {"floor": 1, "cfl": 3}}))
    step_phases.main([str(path)])
    out = capsys.readouterr().out
    assert "dt set by: floor 25.0%, ceiling 0.0%, cfl 75.0% of the steps" in out
    assert json.loads(out.splitlines()[-1])["dt_bounds"] == {"floor": 0.25, "ceiling": 0.0,
                                                             "cfl": 0.75}


def test_padded_steps_count_the_bound_of_each_dt():
    """From rest at timestep_min the WCSPH step's dt doubles up to its
    ceiling: each step counts once in timemanager.CLAMPS."""
    solver, boundary, carry = _padded("wcsph_padded_k5")
    timemanager.CLAMPS.clear()
    carry, _ = solver.simulate(carry, boundary, 3)
    assert dict(timemanager.CLAMPS) == {"ceiling": 3}
