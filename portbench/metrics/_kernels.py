"""Shared by the kernel and glue metrics.

A kernel metric names its kernels once, in its module's `PATTERNS`
(substrings of the traced kernel names); a metric of the same kernels
imports them from there. The glue is every traced device operation that
none of the cell's own kernel metrics claims. It reads None where one of
them claims nothing: a renamed kernel then silences its own metric and the
glue's, instead of moving its time into the glue unseen."""

from portbench import registry


def select(r, patterns):
    if r.trace is None:
        return []
    return [op for op in r.trace.ops if any(p in op.name for p in patterns)]


def claimed(r) -> list:
    """The PATTERNS of each of the cell's per-layer metrics that has them."""
    found = (getattr(registry.reader("metrics", name), "PATTERNS", None)
             for name in r.per_layer)
    return [tuple(p) for p in found if p]


def glue(r):
    if r.trace is None:
        return []
    owned = claimed(r)
    if any(not select(r, patterns) for patterns in owned):
        return []
    names = tuple(p for patterns in owned for p in patterns)
    return [op for op in r.trace.ops if not any(p in op.name for p in names)]


def ms_per_step(r, patterns):
    ops = select(r, patterns)
    return sum(op.dur_us for op in ops) * 1e-3 / len(r.records) if ops else None
