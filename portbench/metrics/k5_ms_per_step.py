"""k5_ms_per_step (layer: K5 pair reduction): device ms a step of the
kernels named tile_pair_reduce_kernel (ops/pallas_pair.py,
csrc/tile_pair_reduce.cu)."""

from portbench.metrics._kernels import ms_per_step

PATTERNS = ("tile_pair_reduce_kernel",)


def read(r):
    return ms_per_step(r, PATTERNS)
