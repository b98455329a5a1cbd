"""Device times of the plane kernels K1 (every call form of a plane step) and
K2 on a settled double dam-break state, through the public wrappers only.

    python -m yasph2d_tpu_torch.tools.kernel_times [--kind dfsph_plane_bf16]
        [--particles 1000000] [--steps 100]

`--kind` is a plane solver of `scenes.SOLVERS` (dfsph_plane, dfsph_plane_bf16,
wcsph_plane, wcsph_plane_bf16). The scene runs init_carry + `--steps` steps,
then each of the step's K1 forms is timed on that state with seeded velocity,
stiffness and density noise (as chip_smoke.py phase 3), and K2 on the step's
own advection with the step's payload stacked as one (D, P, ny, nx) tensor.
Times are device milliseconds per call: 10 calls in a CUDA graph, CUDA
events, median of 7. It calls only `pair_reduce.pair_reduce`,
`rebucket.rebucket` and the scene API, so the same file times two trees of
the package in one run: put the other tree first on PYTHONPATH and run this
file by its path. Needs a CUDA device; prints one JSON line.
"""

import argparse
import json

import numpy as np
import torch


def noise(rng, t, scale):
    return torch.as_tensor(rng.normal(0.0, scale, tuple(t.shape)).astype(np.float32),
                           device=t.device)


def plane_calls(solver, boundary, carry, rng) -> dict:
    """{label: (form, query geometry, source geometry, keyword operands)} of
    a plane step's K1 calls on `carry`."""
    from yasph2d_tpu_torch.models.wcsph import tait_pressure
    from yasph2d_tpu_torch.ops.pair_reduce import pair_reduce
    from yasph2d_tpu_torch.ops.planes import plane_geom

    f, c, dt = solver._forms, solver._consts, float(carry.time.dt)
    if hasattr(carry, "ctx"):  # DFSPH
        ctx = carry.ctx
        q = ctx.geom
        v = carry.v + noise(rng, carry.v, 0.5)
        k = noise(rng, carry.kappa, 50.0)
        stat = pair_reduce(f.ctx, q, boundary.geom, c)
        return {
            "ctx": (f.ctx, q, boundary.geom, {}),
            "ctx_post": (f.ctx_post, q, q, dict(post_planes=(stat,))),
            "visc_gravity": (f.visc_gravity, q, q, dict(q_vals=(v,), s_vals=(v, ctx.densities),
                                                        scalars=(dt,))),
            "err_ki": (f.err_ki, q, q, dict(q_vals=(v,), s_vals=(v,), scalars=(dt,),
                                            post_planes=(v, ctx.sum_grad_stat, ctx.densities,
                                                         ctx.alpha))),
            "delta_ki": (f.delta_ki, q, q, dict(q_vals=(v,), s_vals=(v,), post_planes=(
                v, ctx.sum_grad_stat, ctx.neighbor_total, ctx.alpha))),
            "corr_v": (f.corr_v, q, q, dict(q_vals=(k,), s_vals=(k,), scalars=(1000.0,),
                                            post_planes=(v, k, ctx.sum_grad_stat))),
        }
    q = plane_geom(carry.pos, carry.mask, solver.grid)
    dens = torch.where(carry.mask, carry.dens + noise(rng, carry.dens, 5.0).abs(), carry.dens)
    v = carry.v + noise(rng, carry.v, 0.5)
    wv = (tait_pressure(solver.stiffness, solver.properties.fluid_density, dens), dens, v)
    return {
        "wcsph_density": (f.density, q, q, {}),
        "wcsph_stat": (f.stat, q, boundary.geom, {}),
        "wcsph_forces": (f.forces, q, q, dict(q_vals=wv, s_vals=wv, scalars=(dt,))),
    }


def main(argv=None):
    from yasph2d_tpu_torch.ops.pair_reduce import pair_reduce
    from yasph2d_tpu_torch.ops.rebucket import rebucket
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="dfsph_plane_bf16")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    device = torch.device("cuda", 0)

    world = double_dam_break(args.particles)
    solver, boundary = bench_solver(args.kind, world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, args.steps)
    torch.cuda.synchronize()
    c = solver._consts
    times = {}
    for label, (form, q, s, kw) in plane_calls(solver, boundary, carry,
                                               np.random.default_rng(0)).items():
        times[label] = graph_ms(lambda form=form, q=q, s=s, kw=kw:
                                pair_reduce(form, q, s, c, **kw))
    if hasattr(carry, "ctx"):
        mask, pos, dt = carry.ctx.mask, carry.ctx.pos, float(carry.time.dt)
        values = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]])
    else:
        mask, pos, dt = carry.mask, carry.pos, float(carry.time.dt)
        values = carry.v.contiguous()
    adv = pos + carry.v * dt
    times["rebucket"] = graph_ms(lambda: rebucket(adv, mask, values, solver.grid))
    print(json.dumps({"kind": args.kind, "particles": args.particles, "steps": args.steps,
                      "live": int(mask.sum()), "device": torch.cuda.get_device_name(0),
                      "ms": times}), flush=True)


if __name__ == "__main__":
    main()
