"""k5_roofline (layer: K5 pair reduction): the K5 launches' bounds summed
over the traced replay, over their measured device time, in %. A launch's
bound is its pass's (roofline_rules.py) on the segment's start state,
found by the term functor in the kernel's name; the passes of one functor
(the ctx pass to the fluid and to the boundary) share their mean. None if a
K5 launch has no bound."""

from portbench.metrics._kernels import select
from portbench.metrics.k5_ms_per_step import PATTERNS


def read(r):
    ops = select(r, PATTERNS)
    if not ops:
        return None
    bounds = r.roofline["k5"]
    total = 0.0
    for op in ops:
        functor = op.name.split("tile_pair_reduce_kernel<", 1)[-1]
        match = [b for f, b in bounds.items() if functor.startswith(f)]
        if len(match) != 1:
            return None
        total += match[0]
    return 100.0 * total / (sum(op.dur_us for op in ops) * 1e-6)
