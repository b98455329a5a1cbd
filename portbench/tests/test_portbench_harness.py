"""CPU tests of the benchmark harness: the files it finds by name, the JAX
import check, the trace reduction, and a whole run of a small scene on the
program's CPU twins.

    python -m pytest portbench/tests

The test marked `cuda` needs the card and skips without one.
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import compare, harness, registry, trace_reduce

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
ALL = registry.with_parked(BENCH)  # with the DFSPH cells held out of BENCHMARK.json
ALL_CELLS = [w["name"] for w in ALL["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = {"target_particles": 3000, "settle_steps": 3, "segment_steps": 4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small_run(cell, **kw):
    return harness.run_cell(ROOT, cell, 2**31 + 7, 0.5, kw.pop("trace", False),
                            torch.device("cpu"), time.perf_counter(),
                            size=dict(SMALL, **kw.pop("size", {})), log=lambda *a: None,
                            bench=ALL, **kw)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_registry_finds_every_file(cell):
    c = registry.cell(ROOT, cell, ALL)
    assert c.config["method"] in ("dfsph", "wcsph")
    assert callable(registry.adapter(c.config["adapter"]).step)
    assert c.scene["fluid_rects"] and c.scene["boundary_thick_lines"] and c.scene["tank"]
    assert {"occupancy", "settle_steps", "segment_steps", "compare_steps",
            "limits"} <= set(c.settings)
    for m in c.end_to_end:
        assert callable(registry.reader("e2e", m["name"]).read)
    for m in c.per_layer:
        assert callable(registry.reader("metrics", m["name"]).read)
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_parked"])
def test_benchmark_names_and_files(bench):
    cells = [w["name"] for w in bench["workloads"]]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + cells
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        assert set(m.get("workloads", cells)) <= set(cells)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)


@pytest.mark.parametrize("modules, found", [
    ({"jax": 0, "jax.numpy": 0}, ["jax"]),
    ({"jaxlib.xla_client": 0}, ["jaxlib"]),
    ({"flax.linen": 0}, ["flax"]),
    ({"yasph2d_tpu.models.dfsph_dense": 0}, ["yasph2d_tpu"]),
    ({"yasph2d_tpu_torch": 0, "yasph2d_tpu_torch.ops.sm_rebucket": 0, "jaxtyping": 0}, []),
])
def test_import_check_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def test_harness_loads_no_jax():
    """Everything a run imports, in a fresh process: no JAX module."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, registry, compare\n"
        "import yasph2d_tpu_torch, yasph2d_tpu_torch.config\n"
        "from yasph2d_tpu_torch.ops import cuda_build\n"
        "for a in ('dfsph_padded', 'wcsph_padded'): registry.adapter(a)\n"
        "print(harness.forbidden_loaded())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_trace_reduction():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void a<int>(int)", "ts": 0, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "void b(float)", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 40, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 14, "dur": 40},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void a<int>(int)", "ts": 60, "dur": 10},
    ]
    t = trace_reduce.reduce(ev, 1e-4)
    assert t.busy_s == pytest.approx(30e-6)
    assert t.gaps == [("cudaMemcpyAsync", pytest.approx(25e-6)),
                      ("aten::item", pytest.approx(15e-6))]
    assert trace_reduce.reduce(ev[:3] + ev[5:], 1e-4).gaps[1][0] == "host python"
    b = trace_reduce.breakdown(t)
    assert b["device_ops"][0] == ["a<int>", pytest.approx(20e-6)]
    assert b["idle_gaps"][0][0] == "cudaMemcpyAsync"


def _traced(names, per_layer):
    ops = [trace_reduce.DeviceOp(n, float(i), 2.0) for i, n in enumerate(names)]
    tr = trace_reduce.Trace(ops=ops, busy_s=1e-5, gaps=[], window_s=1e-4)
    win = harness.Window(steps=1, window_s=1.0, step_s=[1.0], n_live=1, setup_s=1.0)
    return harness.Readings(win, tr, [None], {}, 0.0, per_layer)


KERNEL_METRICS = ["k5_ms_per_step", "k4_ms_per_step", "glue_ms_per_step"]


@pytest.mark.parametrize("names, glue", [
    (["tile_pair_reduce_kernel<DivXlaTerm>", "sm_rebucket_staged<4>", "elementwise_add",
      "Memcpy DtoH"], 2),
    # a renamed K5 kernel: K5 reads nothing, and neither does the glue
    (["tile_pair_kernel<DivXlaTerm>", "sm_rebucket_staged<4>", "elementwise_add"], None),
])
def test_glue_is_what_no_kernel_metric_claims(names, glue):
    r = _traced(names, KERNEL_METRICS)
    launches = registry.reader("metrics", "glue_launches_per_step").read(r)
    assert launches == glue
    k5 = registry.reader("metrics", "k5_ms_per_step").read(r)
    assert (k5 is None) == (glue is None)


def test_kernel_names_live_in_one_module_each():
    for kernel in ("k4", "k5"):
        ms = registry.reader("metrics", f"{kernel}_ms_per_step")
        assert registry.reader("metrics", f"{kernel}_roofline").PATTERNS == ms.PATTERNS


@pytest.mark.parametrize("x, y, out", [(1.0, 0.5, 0), (1.0, -0.02, 0), (1.0, -0.04, 1),
                                       (1.0, 2.6, 1), (2.0, 0.2, 1), (2.0, 0.46, 0)])
def test_leaked_counts_fluid_past_a_wall(x, y, out):
    scene = json.loads((ROOT / "portbench/scenes/double_dam_break.json").read_text())
    pos = torch.tensor([[[[1.0, 0.5], [x, y]]]])
    state = {"pos": pos, "mask": torch.tensor([[[True, True]]])}
    assert compare.leaked(state, scene, 0.01) == out


@pytest.mark.parametrize("cell", ["dfsph_dambreak2_1m", "wcsph_dambreak2_1m"])
def test_small_run_prints_the_contract_line(cell):
    res = small_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in registry.cell(ROOT, cell, ALL).end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["attempted"] >= SMALL["segment_steps"]
    json.dumps(res)


def test_small_traced_run_reads_per_layer_metrics():
    res = small_run("dfsph_dambreak2_1m", trace=True)
    assert res["correct"] is True
    # no device operation on the CPU: only the host metrics read
    assert set(res["metrics"]) == {"init_carry_s", "pressure_iterations_per_step"}
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                          "--seed", "12345", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
