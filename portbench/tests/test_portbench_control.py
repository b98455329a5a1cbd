"""The comparison must fail what it is there to catch.

- The control: the program's own bfloat16 pair math (K5's bf16 mode, the
  `--pair-dtype bfloat16` switch), the precision below the configuration's
  float32, against the float32 reference, at the cells' own limits.
- The faults, planted under the timed step while the rest of the run is as
  the benchmark runs it: a step that returns its state unchanged; a step
  that leaves half of the particles (every other cell row) with the
  velocity they had before it; one particle's velocity altered where the
  step produces it; one particle moved out of the tank.

On the CPU the program runs its plain twins, at a small scene; the test
marked `cuda` runs the control on the card at the cell's own size.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import harness, registry

ROOT = Path(__file__).resolve().parents[2]
# the DFSPH cell is held out of BENCHMARK.json (parked.json); its comparison is kept sound
CELLS = ("dfsph_dambreak2_1m", "wcsph_dambreak2_1m")
ALL = registry.with_parked(registry.benchmark(ROOT))


def small_run(cell, settle, **kw):
    return harness.run_cell(ROOT, cell, 2**33 + 11, 0.5, False, torch.device("cpu"),
                            time.perf_counter(),
                            size={"target_particles": 3000, "settle_steps": settle,
                                  "segment_steps": 4},
                            log=lambda *a: None, bench=ALL, **kw)


def unchanged(step):
    def run(system, carry):
        _, rec = step(system, carry)
        return carry, rec
    return run


def half_left_out(step):
    def run(system, carry):
        new, rec = step(system, carry)
        rows = torch.arange(new.v_pad.shape[0]) % 2 == 1
        stale = torch.where(rows[:, None, None, None], carry.v_pad, new.v_pad)
        return new._replace(v_pad=stale), rec
    return run


def one_altered(step):
    def run(system, carry):
        new, rec = step(system, carry)
        mask = new.ctx.mask if hasattr(new, "ctx") else new.mask
        flat = new.v_pad.reshape(-1, 2).clone()
        flat[int(mask.reshape(-1).nonzero()[0, 0]), 0] += 0.01
        return new._replace(v_pad=flat.reshape(new.v_pad.shape)), rec
    return run


def one_escaped(step):
    def run(system, carry):
        new, rec = step(system, carry)
        ctx = new.ctx if hasattr(new, "ctx") else new
        flat = ctx.pos_pad.reshape(-1, 2).clone()
        flat[int(ctx.mask.reshape(-1).nonzero()[0, 0]), 1] -= 1.0
        pos = flat.reshape(ctx.pos_pad.shape)
        if hasattr(new, "ctx"):
            return new._replace(ctx=ctx._replace(pos_pad=pos)), rec
        return new._replace(pos_pad=pos), rec
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_escaped_particle_is_not_correct(cell):
    res = small_run(cell, 3, step_wrapper=one_escaped)
    assert res["correct"] is False and res["checks"]["leaked"]["value"] >= 1, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    res = small_run(cell, 30, pair_dtype="bfloat16")
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, one_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = small_run(cell, 3, step_wrapper=fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in registry.benchmark(ROOT)["workloads"]])
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                          "--seed", "424242", "--seconds", "2", "--trace", "0",
                          "--pair-dtype", "bfloat16"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is False
