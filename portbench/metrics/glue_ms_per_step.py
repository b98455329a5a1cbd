"""glue_ms_per_step (layer: tensor glue): device ms a step of every traced
device operation that no kernel metric of the cell claims (_kernels.py):
the torch operations of models/*_dense.py, ops/dense_grid.py and
timemanager.py, their copies and fills."""

from portbench.metrics._kernels import glue


def read(r):
    ops = glue(r)
    return sum(op.dur_us for op in ops) * 1e-3 / len(r.records) if ops else None
