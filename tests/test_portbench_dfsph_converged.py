"""The benchmark's DFSPH cell, `dfsph_converged_dambreak2_1m`, run whole on
the CPU through `portbench.harness.run_cell` at a small size: the program's
K5 + K4 twins against the plain reference (portbench/reference/), no JAX.

At ~1000 particles the floor impact comes at step 27 (the first step whose
density loop iterates more than once); the cell's 4 replayed steps, 26-29,
run into it (1, 3, 7 and 12 iterations), so every draw of the 3 compared
steps holds an iterating one. The program is `correct`; the control, the
program's bf16 pair math, is not. At this size the two runs take ~45 s on
one CPU thread."""

import time
from pathlib import Path

import numpy as np
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
CELL = "dfsph_converged_dambreak2_1m"
SEED = 2**31 + 7
SIZE = {"target_particles": 1000, "settle_steps": 26, "segment_steps": 4}


def small_run(pair_dtype=None):
    """The result line and every step's record, in the order run."""
    records = []

    def wrapper(step):
        def run(system, carry):
            carry, rec = step(system, carry)
            records.append(rec)
            return carry, rec
        return run

    res = harness.run_cell(ROOT, CELL, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), pair_dtype=pair_dtype, step_wrapper=wrapper,
                           size=SIZE, log=lambda *a: None)
    return res, records


def compared(records):
    """The records of the compared steps: the harness keeps 3 consecutive
    steps of the window's first replay, from a start drawn from the seed."""
    settle, segment, n = SIZE["settle_steps"], SIZE["segment_steps"], 3
    first = int(np.random.default_rng(SEED % 2**64).integers(0, segment - n + 1))
    replay = records[settle + segment:settle + 2 * segment]  # after the warm-up replay
    return replay[first:first + n]


def test_program_is_correct_through_the_impact():
    res, records = small_run()
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["checks"]["iterations"]["value"] == 0
    assert max(r.density_iterations for r in compared(records)) > 1
    assert {"particle_steps_per_s", "step_ms_p95", "setup_s"} == set(res["metrics"])


def test_control_is_not_correct():
    res, _ = small_run(pair_dtype="bfloat16")
    assert res["correct"] is False, res["checks"]
