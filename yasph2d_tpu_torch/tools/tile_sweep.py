"""Launch shapes of the tiled pair kernels K5 and K3 (csrc/tile_pair_reduce.cu)
and K1 (csrc/pair_reduce.cu) on one GPU.

    python -m yasph2d_tpu_torch.tools.tile_sweep [--kernel k5|k3|k1]
        [--particles 100000] [--steps 3] [--kinds dfsph_padded_k5,...]

K5: steps the double dam-break through the DFSPH and WCSPH padded solvers on
their K5 route, then times K5's call forms on those states (seeded noise, as
chip_smoke.py phase 3) for every (TY, TX, threads) shape of SHAPES whose
block fits; a bf16 kind (`--kinds dfsph_padded_k5_bf16,wcsph_padded_k5_bf16`)
times the forms in K5's bf16 math mode (ops/pallas_pair.py tile_shape with
the mode's staging bytes).
K3: the same on the padded solvers' K3 route, K3's call forms; K3 takes
K5's launch shape (ops/pallas_pair.py tile_shape) unless this shows another.
K1: steps the scene through the DFSPH plane solver in float32 and in bfloat16
operands and the WCSPH plane solver, then times K1's nine call forms on those
states (seeded noise as above) for every (TY, TX, threads) shape of K1_SHAPES.
Every shape must give the default shape's output bit for bit: each query slot
sums its candidates in one order whatever the tile. Times are device
milliseconds per call (10 calls in a CUDA graph, CUDA events, median of 7).
Needs a CUDA device.
"""

import argparse
import json

import numpy as np
import torch

# K5's (TY, TX, threads), TY and TX powers of two and at most 256 threads;
# ops/pallas_pair.py TILE is the choice from here
SHAPES = ((8, 8, 256), (8, 8, 128), (4, 8, 128), (4, 8, 64), (4, 4, 64), (2, 16, 128),
          (4, 16, 256), (8, 16, 256), (16, 8, 256), (16, 16, 256), (8, 32, 256))
# K1's (TY, TX, threads), TY and TX powers of two and at most 256 threads;
# ops/pair_reduce.py TILES takes its choices from here
K1_SHAPES = ((8, 16, 256), (8, 8, 256), (4, 16, 256), (8, 32, 256), (8, 8, 128),
             (4, 16, 128), (4, 8, 128), (2, 16, 128), (4, 8, 64), (2, 8, 32))

K1_KINDS = "dfsph_plane,dfsph_plane_bf16,wcsph_plane,wcsph_plane_bf16"
KINDS = {"k1": K1_KINDS, "k5": "dfsph_padded_k5,wcsph_padded_k5",
         "k3": "dfsph_padded,wcsph_padded"}


def _time_shapes(label, run, default, shapes, results, extra=None):
    """Time `run(shape)` for every shape after checking it against `default`'s
    output bit for bit; appends and prints one row."""
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    ref = run(default)
    row = {"form": label, "default": list(default), **(extra or {})}
    for shape in shapes:
        out = run(shape)
        torch.cuda.synchronize()
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise RuntimeError(f"{label} with tile {shape} differs from {default}")
        row[str(shape)] = graph_ms(lambda shape=shape: run(shape))
    results.append(row)
    print(f"{label:22s} " + " ".join(f"{s}: {row[str(s)]:.5f}" for s in shapes)
          + f" | default {default}", flush=True)


def sweep_k1(args, device) -> list:
    """K1's forms on the plane states of `--kinds` (the step's calls as
    tools/kernel_times.py builds them), every shape of K1_SHAPES."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools.kernel_times import plane_calls

    results = []
    for kind in args.kinds.split(","):
        world = double_dam_break(args.particles)
        solver, boundary = bench_solver(kind, world, device=device)
        carry = solver.init_carry(world.initial_state(device=device), boundary)
        carry, _ = solver.simulate(carry, boundary, args.steps)
        suffix = "_bf16" if solver.grid.pair_dtype == "bfloat16" else ""
        calls = plane_calls(solver, boundary, carry, np.random.default_rng(5))
        q = next(iter(calls.values()))[1]
        print(f"state: {kind}, {int(q.mask.sum())} live, grid {solver.grid.nx}x"
              f"{solver.grid.ny} P {solver.grid.occupancy}, {args.steps} steps", flush=True)
        for label, (form, q, src, kw) in calls.items():
            default = pr.tile_shape(q.mask.shape[0], src.mask.shape[0],
                                    len(pr._planes(kw.get("s_vals", ()))),
                                    q.rebase_cell is not None, *q.mask.shape[1:])

            def run(tile, form=form, q=q, src=src, kw=kw):
                return pr.launch(form, q, src, solver._consts, kw.get("q_vals", ()),
                                 kw.get("s_vals", ()), kw.get("scalars", ()),
                                 kw.get("post_planes", ()), tile)

            _time_shapes(label + suffix, run, default[:3], K1_SHAPES, results,
                         {"smem_bytes": default[3]})
    return results


def sweep_tiles(args, device) -> list:
    """K5's or K3's forms (by the solvers' route) on the padded states of
    `--kinds` (the step's calls as tools/kernel_times.py builds them), every
    shape of SHAPES."""
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools.kernel_times import padded_calls

    results = []
    for kind in args.kinds.split(","):
        world = double_dam_break(args.particles)
        solver, boundary = bench_solver(kind, world, device=device)
        carry = solver.init_carry(world.initial_state(device=device), boundary)
        carry, _ = solver.simulate(carry, boundary, args.steps)
        if solver.grid.use_pallas_slotmajor != (args.kernel == "k3"):
            raise SystemExit(f"tile_sweep: {kind} is not on the {args.kernel} route")
        launch = smp.launch if args.kernel == "k3" else tpp.launch
        mode = {} if args.kernel == "k3" or tpp.rebase_of(solver.grid) is None \
            else dict(rebase=tpp.rebase_of(solver.grid))
        calls = padded_calls(solver, boundary, carry, np.random.default_rng(2))
        q_pos, q_mask = next(iter(calls.values()))[1]
        print(f"state: {kind}, {int(q_mask.sum())} live, grid {solver.grid.nx}x"
              f"{solver.grid.ny} P {solver.grid.occupancy}, boundary Pb "
              f"{boundary.mask.shape[2]}, {args.steps} steps", flush=True)
        for label, (form, q, src, kw) in calls.items():
            sizes = (q[1].shape[2], src[1].shape[2], len(tpp._comps(kw.get("s_vals", ()))),
                     bool(mode))
            default = tpp.tile_shape(*sizes)
            shapes = [t for t in SHAPES if tpp.smem_bytes(*t[:2], *sizes) <= tpp.SMEM_LIMIT]

            def run(tile, form=form, q=q, src=src, kw=kw, launch=launch):
                return launch(form, *q, *src, solver._consts, kw.get("q_vals", ()),
                              kw.get("s_vals", ()), kw.get("scalars", ()), tile, **mode)

            _time_shapes(f"{kind}:{label}", run, default, shapes, results)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k5", "k3", "k1"), default="k5")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--kinds", default=None,
                    help="the solvers whose states are swept (default, by kernel: "
                         f"{KINDS})")
    args = ap.parse_args()
    args.kinds = args.kinds or KINDS[args.kernel]
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA device")
    device = torch.device("cuda", 0)
    print(f"{args.kernel} on {torch.cuda.get_device_name(0)}", flush=True)
    results = (sweep_k1 if args.kernel == "k1" else sweep_tiles)(args, device)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "kernel": args.kernel,
                      "results": results}))


if __name__ == "__main__":
    main()
