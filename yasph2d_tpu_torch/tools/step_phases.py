"""Which phase of a solver step each device operation and idle gap belongs to.

    python -m yasph2d_tpu_torch.tools.step_phases TRACE.json

reads a Chrome trace of the port's steps taken with both host and device
activity (`utils/profiling.trace`, `tools/trace_step.py --trace`) and
prints, for each program scope (`utils/profiling.scope`), the device time,
launches, glue time and idle time that fall to it, a step's worth each, then
the split that the scopes' names give. It needs no device: a trace from the
card can be read anywhere.

The rules, on the trace's one timeline:

- a device operation (a kernel, memcpy or memset) belongs to the innermost
  scope open at the start of the runtime call that launched it, joined by
  its `correlation` id;
- an idle gap between device operations belongs to the innermost scope open
  on the host when the device went idle, that is at the gap's start: inside
  a "sync.*" scope (`profiling.read_back`) the device ran dry while the step
  waited on it; inside a step scope but outside "sync.*" the host's launches
  fell behind; outside every step scope the gap is the caller's;
- glue is every device operation that is not one of the port's kernels
  (`KERNELS`); pair glue is glue launched inside one of `PAIR_SCOPES`, and
  integrate glue the rest of a step's.

The steps counted are the step scopes (`STEP_SCOPES`) in the trace. Beside
the read-backs a step ("sync.*" scopes, `profiling.READBACKS`) the split
gives the launches of the glue kernels a step (`SLOT_GLUE`: the padded
WCSPH step's, ops/slot_glue.py `LAUNCHES`, and the DFSPH pressure loops',
ops/pressure_glue.py `LAUNCHES`).

A DFSPH pressure loop (`LOOP_SCOPES`) reads back its mean residual once an
iteration where the host tests its exit ("sync.mean_residual"), its state
once a chunk of iterations where the device does ("sync.loop_state";
models/dfsph_dense.py `_pressure_loop`). A trace that tools/trace_step.py
wrote carries the loops' iteration counts over its steps (ops/pressure_glue.py
`ITERATIONS`, the trace's "iterations" key); without them a loop's
iterations are its "sync.mean_residual" read-backs, as on the host's test.
For each loop the table `loops` gives the iterations and read-backs a step,
the share of enqueued iterations that the device's test gated off
(`overshoot`: (enqueued - run) / enqueued; None without the counts), and
the device, glue and idle ms and the glue launches and glue kernel launches
(`SLOT_GLUE`) an iteration: everything that falls inside the loop's scope,
its read-backs' idle included, over its iterations.

A trace that tools/trace_step.py wrote also carries, under the key
"clamps", which bound set each traced step's dt (timemanager.py `CLAMPS`);
`dt_bounds` gives each bound's share of the steps: a dt on the floor
(`timestep_min`) says that the floor, not the CFL condition, paces the flow.
"""

import argparse
import json
from typing import NamedTuple, Optional

from ..ops import pressure_glue, slot_glue

STEP_SCOPES = ("WCSPH.step", "DFSPH.step")
# the phases of a padded step that run pair passes, and the glue between them
PAIR_SCOPES = ("WCSPH.pairs", "DFSPH.viscosity", "DFSPH.context", "DFSPH.density_loop",
               "DFSPH.divergence_loop")
SYNC_PREFIX = "sync."
# the DFSPH pressure loops, by their loop's name in pressure_glue.ITERATIONS,
# and their read-backs: one an iteration on the host's exit test, one a
# chunk of iterations on the device's
LOOP_SCOPES = {"DFSPH.density_loop": "density", "DFSPH.divergence_loop": "divergence"}
LOOP_SYNC = "sync.mean_residual"
LOOP_SYNCS = (LOOP_SYNC, "sync.loop_state")
# the port's kernels, as substrings of their traced names: K1 / K3 / K5
# (pair_reduce_kernel, tile_pair_reduce_kernel), K2 (rebucket_kernel), K4
KERNELS = ("pair_reduce_kernel", "rebucket_kernel", "sm_rebucket_staged",
           "sm_rebucket_direct")
# the glue kernels of ops/slot_glue.py and ops/pressure_glue.py, by their
# traced names' start: glue, counted apart
SLOT_GLUE = tuple(f"{name}_kernel" for name in (*slot_glue.LAUNCHES, *pressure_glue.LAUNCHES))
# the bounds that can set a step's dt, timemanager.CLAMPS' keys
DT_BOUNDS = ("floor", "ceiling", "cfl")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
NO_SCOPE = "(no scope)"


class Span(NamedTuple):
    start: float
    end: float
    name: str


def _complete(events, categories):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in categories]


def _open_at(spans: list, times: list) -> list:
    """For each time of `times`, the names of the spans open there
    (start <= t < end), outermost first. `spans` nest, as one thread's
    scopes do."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out = [()] * len(times)
    stack, i = [], 0
    for k in order:
        t = times[k]
        while i < len(spans) and spans[i].start <= t:
            while stack and stack[-1].end <= spans[i].start:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        out[k] = tuple(s.name for s in stack)
    return out


def _spans(events) -> list:
    # by start, the outer of two spans that start together first
    return sorted((Span(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                   for e in _complete(events, ("user_annotation",))),
                  key=lambda s: (s.start, -s.end))


def operations(events: list, spans=None) -> list:
    """The device operations in start order, each with the names of the
    scopes open at its launch, outermost first."""
    spans = _spans(events) if spans is None else spans
    launch_at = {e["args"]["correlation"]: float(e["ts"])
                 for e in _complete(events, LAUNCH_CATEGORIES)
                 if "correlation" in e.get("args", {})}
    ops = sorted(_complete(events, DEVICE_CATEGORIES), key=lambda e: float(e["ts"]))
    # an operation whose launch the trace lacks is placed at its own start
    return list(zip(ops, _open_at(spans, [launch_at.get(e.get("args", {}).get("correlation"),
                                                        float(e["ts"])) for e in ops])))


def attribute(events: list, iterations: Optional[dict] = None,
              clamps: Optional[dict] = None) -> dict:
    """The per-scope table, the split, the loops and the dt bounds of a
    trace's events (the module docstring's rules); times in ms a step (the
    loops': an iteration); split None and no loops where the trace holds no
    step scope. `iterations`: the loops' counts over the trace's steps
    (pressure_glue.ITERATIONS' keys), or None; `clamps`: the steps by the
    bound that set their dt (timemanager.CLAMPS' keys), or None."""
    spans = _spans(events)
    op_stacks = operations(events, spans)
    ops = [e for e, _ in op_stacks]
    gaps, end = [], None
    for e in ops:
        start, stop = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if end is not None and start > end:
            gaps.append((end, start - end))
        end = stop if end is None else max(end, stop)
    gap_stacks = _open_at(spans, [g[0] for g in gaps])

    steps = sum(s.name in STEP_SCOPES for s in spans)
    if not steps:
        return {"steps": 0, "scopes": {}, "split": None}
    scopes = {}

    def row(stack):
        name = stack[-1] if stack else NO_SCOPE
        return scopes.setdefault(name, {"device_ms": 0.0, "launches": 0, "glue_ms": 0.0,
                                        "glue_launches": 0, "idle_ms": 0.0})

    split = dict.fromkeys(("pair_glue_ms", "integrate_glue_ms", "outside_glue_ms",
                           "sync_idle_ms", "dispatch_idle_ms", "caller_idle_ms"), 0.0)
    # loop scope -> its ms a step
    loops = {name: {"device_ms": 0.0, "glue_ms": 0.0, "idle_ms": 0.0, "glue_launches": 0.0,
                    "slot_glue_launches": 0.0}
             for name in LOOP_SCOPES if any(s.name == name for s in spans)}
    for e, stack in op_stacks:
        ms = float(e.get("dur", 0.0)) * 1e-3 / steps
        r = row(stack)
        r["device_ms"] += ms
        r["launches"] += 1
        loop = _loop_row(loops, stack)
        if loop is not None:
            loop["device_ms"] += ms
        if e["cat"] == "kernel" and any(k in e["name"] for k in KERNELS):
            continue
        r["glue_ms"] += ms
        if loop is not None:
            loop["glue_ms"] += ms
            loop["glue_launches"] += 1 / steps
            loop["slot_glue_launches"] += _slot_glue(e) / steps
        r["glue_launches"] += 1
        if any(s in PAIR_SCOPES for s in stack):
            split["pair_glue_ms"] += ms
        elif any(s in STEP_SCOPES for s in stack):
            split["integrate_glue_ms"] += ms
        else:
            split["outside_glue_ms"] += ms
    for (_, us), stack in zip(gaps, gap_stacks):
        ms = us * 1e-3 / steps
        row(stack)["idle_ms"] += ms
        loop = _loop_row(loops, stack)
        if loop is not None:
            loop["idle_ms"] += ms
        if any(s.startswith(SYNC_PREFIX) for s in stack):
            split["sync_idle_ms"] += ms
        elif any(s in STEP_SCOPES for s in stack):
            split["dispatch_idle_ms"] += ms
        else:
            split["caller_idle_ms"] += ms
    for r in scopes.values():
        r["launches"] /= steps
        r["glue_launches"] /= steps
    split["syncs"] = sum(s.name.startswith(SYNC_PREFIX) for s in spans) / steps
    split["slot_glue_launches"] = sum(map(_slot_glue, ops)) / steps
    for name, loop in loops.items():
        syncs = {sync: sum(s.name == sync and s.start >= o.start and s.end <= o.end
                           for o in spans if o.name == name for s in spans) / steps
                 for sync in LOOP_SYNCS}
        its, overshoot = syncs[LOOP_SYNC], None
        if iterations is not None:
            run = iterations[f"{LOOP_SCOPES[name]}_run"]
            enqueued = iterations[f"{LOOP_SCOPES[name]}_enqueued"]
            its, overshoot = run / steps, (enqueued - run) / enqueued if enqueued else None
        loops[name] = {"iterations": its, "readbacks": sum(syncs.values()),
                       "overshoot": overshoot,
                       **{k: v / its if its else None for k, v in loop.items()}}
    return {"steps": steps, "scopes": scopes, "split": split, "loops": loops,
            "dt_bounds": dt_bounds(clamps)}


def dt_bounds(clamps: Optional[dict]) -> Optional[dict]:
    """Each bound's share of the steps whose dt it set (`clamps`:
    timemanager.CLAMPS' counts), or None without counts."""
    total = sum(clamps.values()) if clamps else 0
    return {bound: clamps.get(bound, 0) / total for bound in DT_BOUNDS} if total else None


def _slot_glue(e) -> bool:
    """Whether device operation `e` is one of the glue kernels (`SLOT_GLUE`)."""
    return e["cat"] == "kernel" and e["name"].removeprefix("void ").startswith(SLOT_GLUE)


def _loop_row(loops: dict, stack):
    """The row of the pressure loop open in `stack`, or None."""
    return next((loops[s] for s in stack if s in loops), None)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a Chrome trace (JSON) of the port's steps")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        data = json.load(f)
    counts = data if isinstance(data, dict) else {}
    result = attribute(counts.get("traceEvents", data), counts.get("iterations"),
                       counts.get("clamps"))
    if not result["steps"]:
        raise SystemExit(f"{args.trace}: no step scope ({', '.join(STEP_SCOPES)})")
    print(f"{result['steps']} steps; a step's ms and launches by innermost scope:")
    print(f"  {'scope':24s} {'device ms':>10s} {'launches':>9s} {'glue ms':>9s} "
          f"{'glue launches':>14s} {'idle ms':>9s}")
    for name, r in result["scopes"].items():
        print(f"  {name:24s} {r['device_ms']:10.4f} {r['launches']:9.2f} {r['glue_ms']:9.4f} "
              f"{r['glue_launches']:14.2f} {r['idle_ms']:9.4f}")
    print("  " + ", ".join(f"{k} {v:.4f}" for k, v in result["split"].items()))
    for name, loop in result["loops"].items():
        print(f"  {name}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in loop.items() if v is not None)
            + " (ms an iteration; iterations and read-backs a step; overshoot: the share "
            "of enqueued iterations gated off)")
    if result["dt_bounds"] is not None:
        print("  dt set by: " + ", ".join(f"{bound} {100.0 * share:.1f}%"
                                          for bound, share in result["dt_bounds"].items())
              + " of the steps")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
