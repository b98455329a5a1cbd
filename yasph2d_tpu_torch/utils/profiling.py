"""Profiling: named scopes + trace capture + step-time history (PyTorch port of
yasph2d_tpu/utils/profiling.py).

Counterpart of the reference's microprofile instrumentation (SURVEY.md section
5): `microprofile::scope!("Group", "name")` becomes a
`torch.profiler.record_function` range named "Group.name", which a
`torch.profiler` trace shows on the host timeline around the device work it
launched; a trace is a Chrome trace file (chrome://tracing, Perfetto).
"""

import collections
import contextlib
import statistics
import time
from pathlib import Path
from typing import Optional

import torch


def scope(group: str, name: str):
    """`microprofile::scope!(group, name)` equivalent: a "group.name" range on
    the profiler's timeline (free of cost while no profiler is recording)."""
    return torch.profiler.record_function(f"{group}.{name}")


@contextlib.contextmanager
def trace(log_dir: str, step_name: Optional[str] = None):
    """Profile everything inside the context: host activity and, where a CUDA
    device is present, the device's; the Chrome trace is written to
    `<log_dir>/trace.json` when the context ends. `step_name` names a range
    around the whole body. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        if step_name is not None:
            with torch.profiler.record_function(step_name):
                yield prof
        else:
            yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Host-side per-step wall-time history (reference: main.rs:61, 277-290 keeps an
    80-sample step duration history for the HUD)."""

    def __init__(self, history_length: int = 80):
        self.history = collections.deque(maxlen=history_length)
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.history.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean(self) -> float:
        return statistics.fmean(self.history) if self.history else 0.0

    @property
    def last(self) -> float:
        return self.history[-1] if self.history else 0.0
