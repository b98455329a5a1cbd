"""How the harness drives one solver of the program: `adapters/<adapter>.py`,
named by a configuration's `adapter` key. Each module gives

- `build(cfg, scene, device, pair_dtype) -> System`: the solver as the
  program's config layer builds it (`config.build_solver`), its boundary
  and `init_carry` of the scene's particles;
- `step(system, carry) -> (carry, Step)`: one step as `simulate` runs it
  (the clock accounted first, then `step`);
- `state(system, carry) -> dict`: the carry's slot tensors and scalars that
  the comparison reads (`compare.py`);
- `k5_calls(system, carry)` and `k4_call(system, carry)`: the operands of the
  step's pair passes and of its re-bucket, for the byte counts of the
  roofline metrics (`roofline_rules.py`).

Nothing here computes a result: it only calls the program and names what
its carry holds.
"""

from typing import Any, NamedTuple


class System(NamedTuple):
    solver: Any
    boundary: Any
    carry: Any


class Step(NamedTuple):
    """What the window keeps of a step's Diagnostics."""

    dt: float
    density_iterations: int
    divergence_iterations: int
    drops: int


class PairCall(NamedTuple):
    """One pair pass of a step, for its byte and operation count."""

    functor: str  # the term functor in the kernel's name
    form: str  # its OPS_PER_PAIR entry
    q_tensors: tuple
    s_tensors: tuple
    masks: tuple
    outputs: tuple  # (shape, ...) of the outputs, float32
    q_pos: Any
    q_mask: Any
    s_pos: Any
    s_mask: Any
