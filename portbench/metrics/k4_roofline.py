"""k4_roofline (layer: K4 re-bucket): K4's bound (roofline_rules.py, on the
segment's start state) times its launches in the traced replay, over their
measured device time, in %."""

from portbench.metrics._kernels import select
from portbench.metrics.k4_ms_per_step import PATTERNS


def read(r):
    ops = select(r, PATTERNS)
    if not ops:
        return None
    return 100.0 * len(ops) * r.roofline["k4"] / (sum(op.dur_us for op in ops) * 1e-6)
