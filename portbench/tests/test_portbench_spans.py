"""The program's profiler scopes in a traced window, on the CPU.

The padded steps open scopes ("WCSPH.step", its phases, "K4.rebucket",
"sync.*"), which a trace holds as `user_annotation` events on the host and
`gpu_user_annotation` events on the device's timeline. They must leave the
trace reduction and every per-layer metric as they were, and the program's
own reader of them (`yasph2d_tpu_torch/tools/step_phases.py`) must split
the same glue that `glue_ms_per_step` reads.

    python -m pytest portbench/tests
"""

import json
from pathlib import Path

import pytest

from portbench import harness, registry, trace_reduce
from yasph2d_tpu_torch.tools import step_phases

ROOT = Path(__file__).resolve().parents[2]
ALL = registry.with_parked(json.loads((ROOT / "BENCHMARK.json").read_text()))
PER_LAYER = [m["name"] for m in ALL["per_layer"]]
STEP_US = 100.0

# (scope, host start, duration) of one step, and the device operations it
# launches: (scope start + offset of the launch, name, category, duration)
SCOPES = [("WCSPH.step", 0, 90), ("WCSPH.kick_drift", 1, 8), ("K4.rebucket", 10, 8),
          ("WCSPH.pairs", 20, 30), ("WCSPH.cfl", 52, 16), ("sync.max_velocity", 60, 7),
          ("WCSPH.kick", 70, 18), ("sync.drops", 80, 7)]
LAUNCHES = [
    (2, "void at::elementwise_kernel<128, 4>(int)", "kernel", 3),
    (11, "void sm_rebucket_staged<false>(SrKernelArgs<false>)", "kernel", 4),
    (21, "void tile_pair_reduce_kernel<WcsphDensityTerm, F32Math>(A)", "kernel", 6),
    (24, "void at::vectorized_elementwise_kernel<4>(int)", "kernel", 2),
    (27, "void tile_pair_reduce_kernel<WcsphStatTerm, F32Math>(A)", "kernel", 5),
    (33, "void tile_pair_reduce_kernel<WcsphForcesXlaTerm<XsphCoef>, F32Math>(A)",
     "kernel", 8),
    (53, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1),
    (55, "void at::reduce_kernel<512, 1>(int)", "kernel", 3),
    (61, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1),
    (71, "void at::elementwise_kernel<128, 2>(int)", "kernel", 2),
    (81, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1),
]


def _events(steps: int, scopes: bool) -> list:
    out, corr = [], 0
    for k in range(steps):
        t0 = k * STEP_US
        device = t0 + 5.0  # the device runs 5 us behind the host
        for at, name, cat, dur in LAUNCHES:
            corr += 1
            device = max(device, t0 + at + 2.0)
            out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                        "ts": t0 + at, "dur": 1.0, "args": {"correlation": corr}})
            out.append({"ph": "X", "cat": "cpu_op", "name": "aten::op", "ts": t0 + at - 0.5,
                        "dur": 2.0})
            out.append({"ph": "X", "cat": cat, "name": name, "ts": device, "dur": float(dur),
                        "args": {"correlation": corr}})
            device += dur
        if scopes:
            for name, start, dur in SCOPES:
                out.append({"ph": "X", "cat": "user_annotation", "name": name,
                            "ts": t0 + start, "dur": float(dur)})
                out.append({"ph": "X", "cat": "gpu_user_annotation", "name": name,
                            "ts": t0 + start + 3, "dur": float(dur)})
    return out


def _readings(events, steps):
    tr = trace_reduce.reduce(events, steps * STEP_US * 1e-6)
    win = harness.Window(steps=steps, window_s=tr.window_s, step_s=[STEP_US * 1e-6] * steps,
                         n_live=1000, setup_s=1.0)
    # a bound for every K5 functor and K4, so that the roofline metrics read
    roofline = {"k5": {"WcsphDensityTerm": 1e-6, "WcsphStatTerm": 1e-6,
                       "WcsphForcesXlaTerm<XsphCoef": 2e-6}, "k4": 1e-6}
    return harness.Readings(win, tr, [None] * steps, roofline, 0.5, PER_LAYER)


def _read(r, name):
    if name == "pressure_iterations_per_step":  # reads Diagnostics, not the trace
        return None
    return registry.reader("metrics", name).read(r)


def test_scopes_leave_the_reduction_and_every_metric_unchanged():
    plain, scoped = _events(3, False), _events(3, True)
    a, b = _readings(plain, 3), _readings(scoped, 3)
    assert a.trace == b.trace
    assert trace_reduce.breakdown(a.trace) == trace_reduce.breakdown(b.trace)
    values = {name: _read(a, name) for name in PER_LAYER}
    assert values == {name: _read(b, name) for name in PER_LAYER}
    assert sum(v is not None for v in values.values()) >= 8


def test_pair_and_integrate_glue_are_the_glue_metric():
    events = _events(3, True)
    split = step_phases.attribute(events)["split"]
    glue = registry.reader("metrics", "glue_ms_per_step").read(_readings(events, 3))
    assert split["outside_glue_ms"] == 0.0
    assert split["pair_glue_ms"] == pytest.approx(0.002)
    assert split["pair_glue_ms"] + split["integrate_glue_ms"] == pytest.approx(glue)
    assert split["syncs"] == 2.0
