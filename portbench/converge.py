"""How a DFSPH configuration's density tolerance was settled: runs of the
program's padded DFSPH step from the scene's start, each step's pressure
loops, dt, density error, drops and fluid past a wall, with the tolerance
derived from the run's own dt; the benchmark's own runs never run it.

    python3 portbench/converge.py --workload <cell> --cfl 1.5,1.0 --seeds 1,2,3
        [--tol auto | --tol 6e-08] [--occupancy 10] [--before 7] [--segment 150]
        [--after 300] [--out FILE]

The upstream exit test of the constant-density loop is mean error / rho0
x dt < `max_avg_density_error` (dfsph.rs:226), a tolerance per second; the
DFSPH papers hold the mean density error at 0.01% of rho0 a step. `--tol
auto` sets `max_avg_density_error` to 1e-4 x the median dt of the segment,
rounded down to one significant digit: a first run at the cell's own
tolerance, then again at the tolerance its segment's median dt gives,
until the tolerance holds still (three runs at most). The segment
is the `--segment` steps from `--before` steps ahead of the impact (the
first step whose density loop iterates more than once; a negative
`--before` starts it after the impact); each run goes on `--after` steps
past it.

A setting holds when no fluid has passed a wall and nothing was dropped in
any step, no density loop reached its cap, and the mean density error
after the loop stayed at or under 0.01% of rho0 in every segment step.
One JSON line a run: the setting, the segment, what held, the first leak,
iterations a step and step times; with `--out`, every step's row too.
Needs a CUDA device.
"""

import argparse
import copy
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PAPER_ERROR = 1e-4  # mean density error of the DFSPH papers, of rho0 a step


def round_down(x: float) -> float:
    """`x` rounded down to one significant digit."""
    e = math.floor(math.log10(x))
    return float(f"{math.floor(x / 10 ** e + 1e-9)}e{e}")


def run(cell, cfg, seed, occupancy, before, segment, after, device):
    """Every step's row from the scene's start until `after` steps past the
    segment, or until fluid has been out for 20 steps."""
    import torch

    from portbench import compare, registry, scene_gen

    adapter = registry.adapter(cfg["adapter"])
    scene = scene_gen.build(cell.scene, cell.traffic["target_particles"], occupancy, seed,
                            device)
    system = adapter.build(cfg, scene, device, cfg["solver"]["pair_dtype"])
    rho0 = scene.fluid_density
    spacing = 2.0 * scene.particle_radius
    carry, rows, impact, end = system.carry, [], None, None
    while end is None or len(rows) < end:
        t = time.perf_counter()
        carry = carry._replace(time=carry.time.account_step())
        carry, d = system.solver.step(carry, system.boundary)
        torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t) * 1e3
        state = adapter.state(system, carry)
        rows.append(dict(
            step=len(rows), dt=float(d.dt), density_iterations=int(d.density_iterations),
            divergence_iterations=int(d.divergence_iterations),
            density_error=float(d.avg_density_error) / rho0, drops=int(d.neighbor_drops),
            leaked=compare.leaked(state, cell.scene, spacing),
            fullest_cell=int(state["mask"].sum(-1).max()),
            max_density=float(compare.live(state, "density").max()) / rho0, ms=ms))
        if impact is None and d.density_iterations > 1:
            impact = len(rows) - 1
            end = impact - before + segment + after
        if sum(r["leaked"] > 0 for r in rows) >= 20:
            break
    return rows, impact


def summary(rows, impact, before, segment, k):
    lo = max(0, (impact if impact is not None else len(rows)) - before)
    seg = rows[lo:lo + segment]
    leaks = [r["step"] for r in rows if r["leaked"]]
    return dict(
        steps=len(rows), impact=impact, segment=[lo, lo + len(seg)],
        median_dt=statistics.median(r["dt"] for r in seg) if seg else None,
        first_leak=leaks[0] if leaks else None,
        most_leaked=max(r["leaked"] for r in rows),
        drops=max(r["drops"] for r in rows),
        fullest_cell=max(r["fullest_cell"] for r in rows),
        capped=sum(r["density_iterations"] > k["max_density_iterations"] for r in rows),
        worst_density_error=max(r["density_error"] for r in seg) if seg else None,
        max_density=max(r["max_density"] for r in rows),
        density_iterations=[sum(r["density_iterations"] for r in seg) / max(1, len(seg)),
                            max((r["density_iterations"] for r in seg), default=0)],
        divergence_iterations=[sum(r["divergence_iterations"] for r in seg) / max(1, len(seg)),
                               max((r["divergence_iterations"] for r in seg), default=0)],
        segment_ms=sum(r["ms"] for r in seg), step_ms_max=max(r["ms"] for r in seg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--cfl", default="1.5")
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--tol", default="auto")
    ap.add_argument("--occupancy", type=int, default=None)
    ap.add_argument("--before", type=int, default=7)
    ap.add_argument("--segment", type=int, default=150)
    ap.add_argument("--after", type=int, default=300)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import registry

    if not torch.cuda.is_available():
        print("converge: needs a CUDA device", file=sys.stderr)
        return 2
    from yasph2d_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    cuda_build.build()
    bench = registry.with_parked(registry.benchmark(ROOT))
    cell = registry.cell(ROOT, args.workload, bench)
    occupancy = args.occupancy or cell.settings["occupancy"]
    out = open(args.out, "w") if args.out else None
    for cfl in (float(c) for c in args.cfl.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            tol = float(cell.config["solver"]["max_avg_density_error"] if args.tol == "auto"
                        else args.tol)
            tried = set()
            while tol not in tried and len(tried) < 3:
                tried.add(tol)
                cfg = copy.deepcopy(cell.config)
                cfg["timestep"]["cfl_factor"] = cfl
                cfg["solver"]["max_avg_density_error"] = tol
                t = time.perf_counter()
                rows, impact = run(cell, cfg, seed, occupancy, args.before, args.segment,
                                   args.after, device)
                s = summary(rows, impact, args.before, args.segment, cfg["solver"])
                s["holds"] = bool(s["first_leak"] is None and s["drops"] == 0
                                  and not s["capped"] and s["worst_density_error"] is not None
                                  and s["worst_density_error"] <= PAPER_ERROR)
                line = dict(cfl=cfl, tol=tol, seed=seed, occupancy=occupancy,
                            wall_s=time.perf_counter() - t, **s)
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(dict(line, rows=rows)) + "\n")
                    out.flush()
                if args.tol != "auto" or s["median_dt"] is None:
                    break
                tol = round_down(PAPER_ERROR * s["median_dt"])
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
