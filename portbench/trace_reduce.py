"""From a `torch.profiler` window to device numbers.

The profiler's Chrome trace of the traced window is written to a temporary
file in TMPDIR, read back and deleted. Its device events (categories
`kernel`, `gpu_memcpy`, `gpu_memset`) give each operation's name and time;
the step runs on one stream, so the device is busy where the union of their
intervals lies (the arithmetic of the port's `tools/trace_step.py`, which
sums their durations). Idle gaps between device operations are named by the
innermost host event open at the gap's middle: a CUDA runtime call (a
`cudaMemcpyAsync` that waits for a read-back, `cudaStreamSynchronize`) or
else an operator; a gap with neither is host Python.
"""

import bisect
import json
import os
import tempfile
from typing import NamedTuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cuda_runtime", "cuda_driver", "cpu_op")
TOP = 10
NAME_CHARS = 160  # a breakdown name's length: torch's kernel templates run to ~600
LOOK_BACK = 64  # host events before a gap's middle searched for one open there


class DeviceOp(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Trace(NamedTuple):
    ops: list  # DeviceOp, in start order
    busy_s: float  # union of the device operations' intervals
    gaps: list  # [(host activity, seconds)], every idle gap inside the window
    window_s: float  # the traced window, host clock


def short_name(name: str) -> str:
    """A kernel's name without its argument list (the demangled signature),
    cut to NAME_CHARS."""
    name = name[5:] if name.startswith("void ") else name
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return name[:i][:NAME_CHARS]
    return name[:NAME_CHARS]


def export_and_read(prof, window_s: float) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return reduce(events, window_s)


def reduce(events: list, window_s: float) -> Trace:
    ops = sorted((DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                  for e in events if e.get("cat") in DEVICE_CATEGORIES and e.get("ph") == "X"),
                 key=lambda o: o.start_us)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                   HOST_CATEGORIES.index(e["cat"]))
                  for e in events if e.get("cat") in HOST_CATEGORIES and e.get("ph") == "X")
    starts = [h[0] for h in host]
    busy_us, gaps, end = 0.0, [], None
    for op in ops:
        stop = op.start_us + op.dur_us
        if end is None or op.start_us >= end:
            if end is not None and op.start_us > end:
                gaps.append((end, op.start_us))
            busy_us += op.dur_us
            end = stop
        elif stop > end:
            busy_us += stop - end
            end = stop
    return Trace(ops=ops, busy_s=busy_us * 1e-6,
                 gaps=[(_host_activity(host, starts, (a + b) / 2), (b - a) * 1e-6)
                       for a, b in gaps],
                 window_s=window_s)


def _host_activity(host: list, starts: list, t: float) -> str:
    """The innermost host event open at time t (runtime calls before
    operators) among the LOOK_BACK that start last before it, or "host
    python"."""
    best = None
    at = bisect.bisect_right(starts, t)
    for start, stop, name, rank in host[max(0, at - LOOK_BACK):at]:
        if t <= stop:
            key = (rank, stop - start)
            if best is None or key < best[0]:
                best = (key, name)
    return best[1] if best else "host python"


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time and the idle time by host
    activity, TOP of each, in seconds."""
    by_op, by_gap = {}, {}
    for op in trace.ops:
        name = short_name(op.name)
        by_op[name] = by_op.get(name, 0.0) + op.dur_us * 1e-6
    for name, seconds in trace.gaps:
        by_gap[name] = by_gap.get(name, 0.0) + seconds
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}
