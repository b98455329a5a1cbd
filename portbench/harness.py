"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up (`setup_s`, from the first statement of run.py to the window):
import, the CUDA context, the kernels (`ops/cuda_build.py`, cached in the
checkout's `build/`), the scene from the seed, the solver and `init_carry`,
`settle_steps` steps to the segment's start state, kept on the device, and
one warm-up replay of the segment, which runs every shape the window runs.

The window replays the segment: it restarts from the kept start state and
runs `segment_steps` steps of the solver, again and again, and closes at the
end of the replay in which `--seconds` have passed, so it always holds
whole replays of the same work. Each step is timed on the host clock up to
a `torch.cuda.synchronize()`. With `--trace 1` the window is one replay
under `torch.profiler`, and the per-layer metrics are read from it.

After the window: the device's peak memory is read, the fluid that has
passed a wall is counted in the segment's start state and at the end of the
last replay, then the plain reference judges the steps kept from the first
replay (compare.py), and then the process checks that no JAX module was
loaded. The log gives the set-up's phases, each in seconds.
"""

import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from . import compare, registry, roofline_rules, scene_gen, trace_reduce
from .reference import consts_of

FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "yasph2d_tpu"})


class Window(NamedTuple):
    steps: int  # steps completed in the window
    window_s: float
    step_s: list  # every step's time
    n_live: int  # live fluid particles
    setup_s: float


class Readings(NamedTuple):
    """What the metric readers read."""

    window: Window
    trace: Optional[trace_reduce.Trace]
    records: list  # adapters.Step of the window's (traced) steps
    roofline: dict  # {"k5": {functor: seconds per launch}, "k4": seconds per launch}
    init_carry_s: float
    per_layer: list  # the names of the cell's per-layer metrics (traced run)


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package (compared whole: yasph2d_tpu_torch is not yasph2d_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN_MODULES)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _roofline(adapter, system, carry, k_radius_sq) -> dict:
    """Each K5 pass's bound (one a functor: the passes of a functor are
    averaged) and K4's, on the segment's start state."""
    by_functor = {}
    for call in adapter.k5_calls(system, carry):
        by_functor.setdefault(call.functor, []).append(
            roofline_rules.pair_bound_s(call, k_radius_sq))
    pos, mask, payload, shapes = adapter.k4_call(system, carry)
    return {"k5": {f: sum(b) / len(b) for f, b in by_functor.items()},
            "k4": roofline_rules.rebucket_bound_s(pos, mask, payload, shapes)}


def run_cell(root, name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, pair_dtype: Optional[str] = None,
             step_wrapper: Optional[Callable] = None, size: Optional[dict] = None,
             all_numbers: bool = False, log=None, bench: Optional[dict] = None) -> dict:
    """Run the cell `name` once and return the result line as a dict.
    `pair_dtype` overrides the configuration's (the control runs the
    program's bfloat16 pair math); `step_wrapper(adapter_step)` returns the
    step the window runs (the fault tests break it); `size` overrides
    `target_particles`, `settle_steps` and `segment_steps` (the CPU tests'
    small runs); `all_numbers` reports the numbers that are not compared
    too (calibrate.py); `bench` stands in for BENCHMARK.json (the CPU tests
    run the DFSPH cells that it does not list, PERF.md section 7)."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    phases, mark = [], [time.perf_counter()]

    def phase(what):
        now = time.perf_counter()
        phases.append(f"{what} {now - (t0 if not phases else mark[0]):.3f}")
        mark[0] = now

    phase("import")
    cell = registry.cell(root, name, bench)
    cfg, settings = cell.config, dict(cell.settings, **(size or {}))
    target = (size or {}).get("target_particles", cell.traffic["target_particles"])
    adapter = registry.adapter(cfg["adapter"])
    run_step = adapter.step if step_wrapper is None else step_wrapper(adapter.step)

    if device.type == "cuda":
        from yasph2d_tpu_torch.ops import cuda_build

        torch.cuda.init()
        torch.empty(1, device=device)
        phase("context")
        cuda_build.build()
        phase("kernels")
    scene = scene_gen.build(cell.scene, target, settings["occupancy"], seed, device)
    k = consts_of(scene, cfg)
    _sync(device)
    phase("scene")
    t = time.perf_counter()
    system = adapter.build(cfg, scene, device, pair_dtype or cfg["solver"]["pair_dtype"])
    _sync(device)
    init_carry_s = time.perf_counter() - t
    phase("init_carry")
    init = compare.compact_init(adapter.state(system, system.carry))
    n_live = init["pos"].shape[0]
    carry = system.carry
    for _ in range(settings["settle_steps"]):
        carry, _ = run_step(system, carry)
    start = carry
    _sync(device)
    phase("settle")
    segment = settings["segment_steps"]
    n_compare = settings["compare_steps"]
    first = int(np.random.default_rng(int(seed) % 2**64).integers(0, segment - n_compare + 1))
    # the warm-up replay, holding the carries that the window's first replay
    # keeps, so that the allocator's pool already has room for them
    held = []
    for i in range(segment):
        before = carry
        carry, _ = run_step(system, carry)
        if first <= i < first + n_compare:
            held.append((before, carry))
    del carry, before, held
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0
    phase("warm-up")
    log(f"set-up {setup_s:.3f} s: {n_live} fluid, {scene.boundary.shape[0]} boundary, grid "
        f"{scene.grid.nx} x {scene.grid.ny} x {scene.grid.occupancy}; phases (s): "
        + ", ".join(phases))

    # the window
    kept, records, step_s = [], [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    w0 = time.perf_counter()
    replays = 0
    while True:
        carry = start
        for i in range(segment):
            before = carry
            s0 = time.perf_counter()
            carry, rec = run_step(system, carry)
            _sync(device)
            step_s.append(time.perf_counter() - s0)
            if replays == 0:
                records.append(rec)
                if first <= i < first + n_compare:
                    kept.append((before, carry, rec))
        replays += 1
        if trace or time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    tr = None
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    spacing = 2.0 * scene.particle_radius
    held_in = {"leaked": max(compare.leaked(adapter.state(system, c), cell.scene, spacing)
                             for c in (start, carry))}
    del carry, before
    win = Window(steps=len(step_s), window_s=window_s, step_s=step_s, n_live=n_live,
                 setup_s=setup_s)
    its = sum(r.density_iterations + r.divergence_iterations for r in records)
    log(f"window {window_s:.3f} s: {replays} replays of {segment} steps, "
        f"{its / segment:.3f} pressure iterations a step")

    if trace:
        tr = trace_reduce.export_and_read(prof, window_s)
        del prof
        readings = Readings(win, tr, records, _roofline(adapter, system, start, k.h * k.h),
                            init_carry_s, [m["name"] for m in cell.per_layer])
        metric_list, kind = cell.per_layer, "metrics"
    else:
        readings = Readings(win, None, records, {}, init_carry_s, [])
        metric_list, kind = cell.end_to_end, "e2e"
    metrics = {}
    for m in metric_list:
        value = registry.reader(kind, m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # the check, once the window's state is read
    del start
    checks = [compare.check_start(scene.fluid, scene.boundary, init, k, cfg["method"]),
              held_in]
    del init
    for before, after, rec in kept:
        after = adapter.state(system, after)
        nums = compare.check_step(adapter.state(system, before), after, rec, scene.boundary, k,
                                  cfg["method"])
        nums["leaked"] = compare.leaked(after, cell.scene, spacing)
        checks.append(nums)
    del kept
    # a number the cell gives no limit is not compared (PERF.md section 2
    # says why); `all_numbers` reports it all the same, with no limit
    limits = settings["limits"]
    failed = sum(any(not (v <= limits[key]) for key, v in nums.items() if key in limits)
                 for nums in checks)
    numbers = compare.worst(checks)
    report = {key: {"value": numbers[key], "limit": limits.get(key)} for key in sorted(numbers)
              if key in limits or all_numbers}
    for key, v in report.items():
        log(f"check {key}: {v['value']!r} (limit {v['limit']!r})")

    result = {
        "correct": failed == 0,
        "attempted": win.steps,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = trace_reduce.breakdown(tr)
    result["checks"] = report
    return result
