"""density_iterations_per_step (layer: solver step, host loop): iterations
of the constant-density solve a step over the traced replay, from each
step's Diagnostics. None where no step iterates (a WCSPH cell)."""


def read(r):
    its = sum(s.density_iterations for s in r.records)
    return its / len(r.records) if its else None
