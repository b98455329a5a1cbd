"""k4_ms_per_step (layer: K4 re-bucket): device ms a step of the kernels
named sm_rebucket_staged or sm_rebucket_direct (ops/sm_rebucket.py,
csrc/sm_rebucket.cu)."""

from portbench.metrics._kernels import ms_per_step

PATTERNS = ("sm_rebucket_staged", "sm_rebucket_direct")


def read(r):
    return ms_per_step(r, PATTERNS)
