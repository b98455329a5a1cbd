"""Launch shapes of the tiled pair kernels K5 (csrc/tile_pair_reduce.cu) and
K1 (csrc/pair_reduce.cu) on one GPU.

    python -m yasph2d_tpu_torch.tools.tile_sweep [--kernel k5|k1]
        [--particles 100000] [--steps 3] [--kinds dfsph_plane,...]

K5: steps the double dam-break through the DFSPH padded solver on its K5
route, then times K5's DFSPH call forms on that state (seeded velocity and
stiffness noise, as chip_smoke.py phase 3) for several (BR, BC, threads)
launch shapes, with K3's form on the same operands as the yardstick.
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

# (BR, BC, threads); the first is K5's first design, 256 threads looping over
# an 8 x 32 tile; (8, 8, 448) is the default at P = 7 (ops/pallas_pair.py)
SHAPES = ((8, 32, 256), (8, 32, 1024), (8, 16, 896), (8, 8, 448), (4, 32, 896),
          (4, 16, 448), (16, 8, 896))
# K1's (TY, TX, threads), TY and TX powers of two and at most 256 threads;
# ops/pair_reduce.py TILES takes its choices from here
K1_SHAPES = ((8, 16, 256), (8, 8, 256), (4, 16, 256), (8, 32, 256), (8, 8, 128),
             (4, 16, 128), (4, 8, 128), (2, 16, 128), (4, 8, 64), (2, 8, 32))


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


def sweep_k5(args, device) -> list:
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.ops.sm_pair_reduce import _comps
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools.kernel_times import noise
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    world = double_dam_break(args.particles)
    solver, boundary = bench_solver("dfsph_padded_k5", world, device=device)
    k3, _ = bench_solver("dfsph_padded", world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, args.steps)
    ctx, c = carry.ctx, solver._consts
    rng = np.random.default_rng(2)
    v = torch.where(ctx.mask[..., None], carry.v_pad + noise(rng, carry.v_pad, 0.5),
                    carry.v_pad)
    k = torch.where(ctx.mask, noise(rng, carry.kappa_pad, 50.0), 0.0)
    fluid = (ctx.pos_pad, ctx.mask)
    f5, f3 = solver._padded_forms, k3._padded_forms
    calls = {  # label: (K5 form, K3 form, source, keyword operands)
        "ctx": (f5.ctx, f3.ctx, fluid, {}),
        "ctx[boundary]": (f5.stat, f3.stat, (boundary.pos_pad, boundary.mask), {}),
        "div": (f5.div, f3.div, fluid, dict(q_vals=(v,), s_vals=(v,))),
        "corr": (f5.corr, f3.corr, fluid, dict(q_vals=(k,), s_vals=(k,))),
        "visc": (f5.visc, f3.visc, fluid, dict(q_vals=(v,), s_vals=(v, ctx.densities_pad),
                                               scalars=(float(carry.time.dt),))),
    }
    print(f"state: {int(ctx.mask.sum())} live, grid {solver.grid.nx}x{solver.grid.ny} "
          f"P {solver.grid.occupancy}, boundary Pb {boundary.mask.shape[2]}", flush=True)
    results = []
    for label, (form5, form3, (s_pos, s_mask), kw) in calls.items():
        default = tpp.tile_shape(ctx.mask.shape[2], s_mask.shape[2],
                                 len(_comps(kw.get("s_vals", ()))))

        def run(tile, form5=form5, s_pos=s_pos, s_mask=s_mask, kw=kw):
            return tpp.launch(form5, *fluid, s_pos, s_mask, c, kw.get("q_vals", ()),
                              kw.get("s_vals", ()), kw.get("scalars", ()), tile)

        k3_ms = graph_ms(lambda form3=form3, s_pos=s_pos, s_mask=s_mask, kw=kw:
                         smp.sm_pair_reduce(form3, *fluid, s_pos, s_mask, c, **kw))
        _time_shapes(label, run, default, SHAPES, results, {"k3_ms": k3_ms})
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k5", "k1"), default="k5")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--kinds", default="dfsph_plane,dfsph_plane_bf16,wcsph_plane,wcsph_plane_bf16",
                    help="K1: the plane solvers whose states are swept")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA device")
    device = torch.device("cuda", 0)
    print(f"{args.kernel} on {torch.cuda.get_device_name(0)}", flush=True)
    results = (sweep_k1 if args.kernel == "k1" else sweep_k5)(args, device)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "kernel": args.kernel,
                      "results": results}))


if __name__ == "__main__":
    main()
