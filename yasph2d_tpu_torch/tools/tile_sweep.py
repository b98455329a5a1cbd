"""Launch shapes of the tiled pair kernel K5 (csrc/tile_pair_reduce.cu) on one GPU.

    python -m yasph2d_tpu_torch.tools.tile_sweep [--particles 100000] [--steps 3]

Steps the double dam-break through the DFSPH padded solver on its K5 route,
then times K5's DFSPH call forms on that state (seeded velocity and stiffness
noise, as chip_smoke.py phase 3) for several (BR, BC, threads) launch shapes,
with K3's form on the same operands as the yardstick. Every shape must give
the default shape's output bit for bit: each query slot sums its candidates
in one order whatever the tile. Times are device milliseconds per call (10
calls in a CUDA graph, CUDA events, median of 7). Needs a CUDA device.
"""

import argparse
import json

import numpy as np
import torch

# (BR, BC, threads); the first is K5's first design, 256 threads looping over
# an 8 x 32 tile; (8, 8, 448) is the default at P = 7 (ops/pallas_pair.py)
SHAPES = ((8, 32, 256), (8, 32, 1024), (8, 16, 896), (8, 8, 448), (4, 32, 896),
          (4, 16, 448), (16, 8, 896))


def main():
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.ops.sm_pair_reduce import _comps
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep needs a CUDA device")
    device = torch.device("cuda", 0)

    world = double_dam_break(args.particles)
    solver, boundary = bench_solver("dfsph_padded_k5", world, device=device)
    k3, _ = bench_solver("dfsph_padded", world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, args.steps)
    ctx, c = carry.ctx, solver._consts
    rng = np.random.default_rng(2)

    def noise(t, scale):
        return torch.as_tensor(rng.normal(0.0, scale, tuple(t.shape)).astype(np.float32),
                               device=device)

    v = torch.where(ctx.mask[..., None], carry.v_pad + noise(carry.v_pad, 0.5), carry.v_pad)
    k = torch.where(ctx.mask, noise(carry.kappa_pad, 50.0), 0.0)
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
          f"P {solver.grid.occupancy}, boundary Pb {boundary.mask.shape[2]}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    results = []
    for label, (form5, form3, (s_pos, s_mask), kw) in calls.items():
        default = tpp.tile_shape(ctx.mask.shape[2], s_mask.shape[2],
                                 len(_comps(kw.get("s_vals", ()))))

        def run(tile=default, form5=form5, s_pos=s_pos, s_mask=s_mask, kw=kw):
            return tpp.launch(form5, *fluid, s_pos, s_mask, c, kw.get("q_vals", ()),
                              kw.get("s_vals", ()), kw.get("scalars", ()), tile)

        ref = run()
        row = {"form": label, "default": list(default),
               "k3_ms": graph_ms(lambda: smp.sm_pair_reduce(form3, *fluid, s_pos, s_mask,
                                                            c, **kw))}
        for shape in SHAPES:
            out = run(shape)
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise RuntimeError(f"K5 {label} with tile {shape} differs from {default}")
            row[str(shape)] = graph_ms(lambda shape=shape: run(shape))
        results.append(row)
        print(f"{label:14s} K3 {row['k3_ms']:.5f} ms | K5 " + " ".join(
            f"{s}: {row[str(s)]:.5f}" for s in SHAPES) + f" | default {default}",
            flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))


if __name__ == "__main__":
    main()
