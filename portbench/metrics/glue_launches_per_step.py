"""glue_launches_per_step (layer: tensor glue): device operations a step
that no kernel metric of the cell claims (kernels, copies, fills;
_kernels.py)."""

from portbench.metrics._kernels import glue


def read(r):
    ops = glue(r)
    return len(ops) / len(r.records) if ops else None
