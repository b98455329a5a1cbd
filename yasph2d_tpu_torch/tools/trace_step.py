"""Where the time of a solver step goes on one GPU.

    python -m yasph2d_tpu_torch.tools.trace_step
        [--solver dfsph_plane|dfsph_plane_bf16|dfsph_plane_unfused|dfsph_padded|
                  dfsph_padded_k5|dfsph_padded_k5_bf16|wcsph_padded|wcsph_padded_k5|
                  wcsph_padded_k5_bf16|wcsph_plane|wcsph_plane_bf16|dfsph_table|
                  wcsph_table|dfsph_dense|dfsph_dense_k5|dfsph_dense_k5_bf16|
                  wcsph_dense|wcsph_dense_k5|dfsph_dense_cached|
                  dfsph_padded_cached|dfsph_dense_mxu]
        [--particles 100000]
        [--settle 50] [--steps 20] [--trace out.json]

Runs the double dam-break on the card, with the solver as
`scenes.bench_solver` builds it (`*_table`: the neighbour-table solvers, in
torch operations; `*_dense`: the sorted carries; `*_k5`: the padded or sorted
solver on K5 instead of K3; `*_bf16`: K1's bf16 operands or K5's bf16 math
mode; `*_unfused`: the DFSPH plane step's glue in torch; `*_cached`,
`*_mxu`: the loop-gradient variants on K5, f32; adaptive CFL 1.5 for
DFSPH, 0.2 for WCSPH): `--settle` steps first
(per-window ms/step, iteration counts and drops are printed), then `--steps`
steps under torch.profiler. Reports the host-clock ms/step of the profiled
window, the device time per kernel name (per step and per launch), and the
device's busy and idle shares of the window (one stream, so busy = the sum of
kernel and memcpy/memset times) and its operations (kernels, memcpys and
memsets) per step. The trace (`--trace`) also carries the DFSPH pressure
loops' iteration counts over the profiled steps (ops/pressure_glue.py
`ITERATIONS`) under the key "iterations", and the steps by the bound that
set their dt (timemanager.py `CLAMPS`: floor, ceiling or CFL) under the key
"clamps", which tools/step_phases.py reads. Needs a CUDA device.
"""

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value:
            return float(value)
    return 0.0


def main():
    from yasph2d_tpu_torch import timemanager
    from yasph2d_tpu_torch.ops import pressure_glue
    from yasph2d_tpu_torch.scenes import SOLVERS, bench_solver, double_dam_break

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--solver", choices=list(SOLVERS), default="dfsph_plane")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--settle", type=int, default=50)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--window", type=int, default=50, help="settle report window")
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_step needs a CUDA device")
    device = torch.device("cuda", 0)

    world = double_dam_break(args.particles)
    solver, boundary = bench_solver(args.solver, world, device=device)
    grid = solver.grid
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    n = int(solver.export_state(carry).alive.sum())
    layout = (f"grid {grid.nx}x{grid.ny} P {grid.occupancy}" if hasattr(grid, "nx")
              else f"cell grid h {grid.cell_size:.5f}, K {grid.max_neighbors_dynamic}")
    print(f"scene: {args.solver}, {n} fluid / {world.num_boundary_particles} boundary, "
          f"{layout}, {torch.cuda.get_device_name(0)}", flush=True)

    done = 0
    while done < args.settle:
        k = min(args.window, args.settle - done)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, agg = solver.simulate(carry, boundary, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / k * 1e3
        done += k
        print(f"steps {done - k}-{done}: {ms:.3f} ms/step, iterations/step density "
              f"{agg.density_iterations / k:.2f} divergence "
              f"{agg.divergence_iterations / k:.2f}, max drops {agg.neighbor_drops}, "
              f"dt {float(agg.dt):.3e}, max |v| {float(agg.max_velocity):.3f}",
              flush=True)

    torch.cuda.synchronize()
    pressure_glue.reset_launch_counts()
    timemanager.CLAMPS.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, agg = solver.simulate(carry, boundary, args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
        with open(args.trace) as f:
            data = json.load(f)
        data["iterations"] = dict(pressure_glue.ITERATIONS)
        data["clamps"] = dict(timemanager.CLAMPS)
        with open(args.trace, "w") as f:
            json.dump(data, f)

    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
            rows.append((evt.key, us, evt.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    steps = args.steps
    ops = sum(count for _, _, count in rows) / steps
    print(f"profiled {steps} steps: {wall_ms / steps:.3f} ms/step host clock, "
          f"{ops:.2f} device operations/step, device busy {busy_ms / steps:.3f} ms/step "
          f"({100.0 * busy_ms / wall_ms:.1f}% busy, "
          f"{100.0 - 100.0 * busy_ms / wall_ms:.1f}% idle), iterations/step density "
          f"{agg.density_iterations / steps:.2f} divergence "
          f"{agg.divergence_iterations / steps:.2f}", flush=True)
    for name, us, count in rows[:20]:
        print(f"  {us / 1e3 / steps:8.4f} ms/step  {count / steps:6.2f} launches/step  "
              f"{us / count:9.2f} us/launch  {name[:90]}")
    print(json.dumps({
        "solver": args.solver, "particles": n, "steps": steps, "ms_per_step": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps, "device_ops_per_step": ops,
        "idle_share": 1.0 - busy_ms / wall_ms, "clamps": dict(timemanager.CLAMPS),
        "kernels": [{"name": name, "ms_per_step": us / 1e3 / steps,
                     "launches_per_step": count / steps} for name, us, count in rows],
    }))


if __name__ == "__main__":
    main()
