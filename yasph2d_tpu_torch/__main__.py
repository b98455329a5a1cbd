"""Command-line entry point (PyTorch port of yasph2d_tpu/__main__.py):

    python -m yasph2d_tpu_torch run    [--config cfg.json] [--steps N]
                                       [--device cuda|cpu]
    python -m yasph2d_tpu_torch record [--config cfg.json] [--frames N] [--out DIR]
                                       [--resolution WxH] [--device cuda|cpu]
    python -m yasph2d_tpu_torch dump-config cfg.json   (write the default config)

`run` builds the configuration (config.py; the JAX package's JSON schema),
steps it through `solver.simulate` and prints the JSON line of the JAX
package's `run`. `record` renders a PNG sequence of the configuration's solver
kind and scene through `app.SimulationApp` in recording mode (as in the JAX
package, only the kind and the world reach the app). `--device cpu` runs the
kernels' plain twins. `main(argv)` takes its argument list, so that a caller
can drive it in-process; `run` returns a `Run`: the JSON record and the world,
solver, boundary and final carry; `record` returns the app.
"""

import argparse
import json
import sys
import time
from typing import Any, NamedTuple

import torch


class Run(NamedTuple):
    """What `run` printed, and the simulation it stepped."""

    record: dict
    world: Any
    solver: Any
    boundary: Any
    carry: Any


def _load_config(path):
    from .config import SimulationConfig

    return SimulationConfig.from_json(path) if path else SimulationConfig()


def cmd_run(args) -> Run:
    cfg = _load_config(args.config)
    device = torch.device(args.device)
    world, solver, boundary, carry = cfg.build(device=device)
    print(f"# Dynamic Particles:  {world.num_dynamic_particles}")
    print(f"# Boundary Particles: {world.num_boundary_particles}")

    t0 = time.perf_counter()
    carry, diag = solver.simulate(carry, boundary, args.steps)
    state = solver.export_state(carry)
    pos = state.positions[state.alive]
    finite = bool(torch.isfinite(pos).all())
    elapsed = time.perf_counter() - t0
    record = {
        "steps": args.steps,
        "wall_s": round(elapsed, 3),
        "simulated_s": float(carry.time.total_simulated_time),
        "dt": float(diag.dt),
        "finite": finite,
        "neighbor_drops": int(diag.neighbor_drops),
        "density_iterations": int(diag.density_iterations),
        "divergence_iterations": int(diag.divergence_iterations),
    }
    print(json.dumps(record), flush=True)
    return Run(record, world, solver, boundary, carry)


def cmd_record(args):
    from .app import SimulationApp, UpdateMode

    cfg = _load_config(args.config)
    w, h = (int(v) for v in args.resolution.split("x"))
    app = SimulationApp(
        solver=cfg.solver.kind,
        world=cfg.build_world(),
        resolution=(w, h),
        update_mode=UpdateMode.RECORDING,
        recording_dir=args.out,
        device=args.device,
    )
    app.run(args.frames)
    print(f"wrote {args.frames} frames to {args.out}/")
    if app.warnings:
        print(f"warnings: {list(app.warnings)[:5]}", file=sys.stderr)
    return app


def cmd_dump_config(args):
    from .config import SimulationConfig

    SimulationConfig().to_json(args.path)
    print(f"wrote default config to {args.path}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="yasph2d_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a simulation headless, print stats")
    p_run.add_argument("--config", default=None)
    p_run.add_argument("--steps", type=int, default=300)
    p_run.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_run.set_defaults(fn=cmd_run)

    p_rec = sub.add_parser("record", help="render a PNG sequence")
    p_rec.add_argument("--config", default=None)
    p_rec.add_argument("--frames", type=int, default=60)
    p_rec.add_argument("--out", default="recording")
    p_rec.add_argument("--resolution", default="1920x1080")
    p_rec.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p_rec.set_defaults(fn=cmd_record)

    p_cfg = sub.add_parser("dump-config", help="write the default config JSON")
    p_cfg.add_argument("path")
    p_cfg.set_defaults(fn=cmd_dump_config)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
