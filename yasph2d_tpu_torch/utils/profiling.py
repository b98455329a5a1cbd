"""Profiling: named scopes + trace capture + step-time history (PyTorch port of
yasph2d_tpu/utils/profiling.py).

Counterpart of the reference's microprofile instrumentation (SURVEY.md section
5): `microprofile::scope!("Group", "name")` becomes a
`torch.profiler.record_function` range named "Group.name", which a
`torch.profiler` trace shows on the host timeline around the device work it
launched; a trace is a Chrome trace file (chrome://tracing, Perfetto).

The padded solvers' steps (models/wcsph_dense.py, models/dfsph_dense.py)
open a scope around the step and each of its phases, K4's re-bucket
(ops/sm_rebucket.py) one around itself, and every read of a device value
back to the host goes through `read_back`, which counts it in `READBACKS`
and opens a "sync.<what>" scope: the one place a step waits on the device.
"""

import collections
import contextlib
import statistics
import time
from pathlib import Path
from typing import Optional

import torch


# read-backs by what they read (`read_back`'s `what`), since the process
# started or `reset_readbacks`
READBACKS = collections.Counter()

# what `scope` returns while no profiler records: entering a
# `record_function` costs an operator call even then
_OFF = contextlib.nullcontext(True)


def scope(group: str, name: str):
    """`microprofile::scope!(group, name)` equivalent: a "group.name" range on
    the profiler's timeline while a profiler records, else a shared context
    that does nothing."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(f"{group}.{name}")


def read_back(what: str, value: torch.Tensor):
    """The host number of a 0-d tensor (`.item()`), or the list of a small
    tensor's (`.tolist()`): a device value waits for the device. Counted in
    READBACKS[what] and inside a "sync.<what>" scope."""
    READBACKS[what] += 1
    with scope("sync", what):
        return value.item() if value.dim() == 0 else value.tolist()


def reset_readbacks():
    READBACKS.clear()


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
