"""Device times of a solver step's kernels on a double dam-break state, through
the public wrappers only.

    python -m yasph2d_tpu_torch.tools.kernel_times [--kind dfsph_plane_bf16[,...]]
        [--particles 1000000] [--steps 100] [--shard K] [--save out.pt]
        [--config portbench/configs/dfsph_converged_f32.json]
    python -m yasph2d_tpu_torch.tools.kernel_times --compare OLD.pt NEW.pt

`--kind` is a solver of `scenes.SOLVERS` (several, comma-separated, run one
after another in the process), or `probe_ctx`: K7 on the probe's
planes at its check shape and at its gpu shape, and K1's ctx form beside it
(tools/probe_pallas_slotmajor.py), with no scene. The scene runs init_carry +
`--steps` steps (the per-step iteration counts and drops are reported), then
each of the step's pair calls is timed on that state with seeded velocity,
stiffness and density noise (as chip_smoke.py phase 3), and the re-bucket on
the step's own advection with the step's payload, as the step calls it:
plane kinds K1's forms and K2 (`rebucket.rebucket`, the payload stacked as
one (D, P, ny, nx) tensor); padded kinds (dfsph_padded, dfsph_padded_k5,
wcsph_padded, wcsph_padded_k5, and the *_k5_bf16 kinds in K5's bf16 math
mode) K3's or K5's forms (`sm_pair_reduce`, `pallas_pair_reduce`) and K4
with its glue: `sm_rebucket_parts` where the
tree has it, else the concatenation, `sm_rebucket` and the splits that the
step around it made; the sorted DFSPH kinds (dfsph_dense*) their K3 or K5
forms (they launch no K4). The padded WCSPH kinds also time the step's
four glue kernels (ops/slot_glue.py) on the operands the step gives them
(`glue_calls`), and print for each, under "glue", its ms and its twin's,
its byte bound (tools/roofline.py `glue_bytes`), whether it gives the
twin's bits, and its launches a step in the `--steps` run (not saved).
The padded DFSPH kinds time the pressure loops' two glue kernels
(ops/pressure_glue.py) the same way, on the operands a density-loop
iteration gives them (`pressure_glue_calls`: slot_pressure_err in the
density loop's mode, and in the divergence loop's as
`slot_pressure_err_divergence`, slot_pressure_kick), their bounds by
tools/roofline.py `pressure_glue_bytes`; their "bit_equal" holds every slot
of k_i, k_sum and v to the twin's bits and the error's total to 1e-6 of the
twin's (`pressure_glue_check`); and, where the tree has the loops' exit
test on the device (ops/pressure_glue.py `err_launcher`), under "gated"
the ms of each of an iteration's four loop launches gated off
(`gated_calls`: K5's or K3's div and corr passes, the error kernel with
its test, the kick), the cost of an iteration enqueued past a loop's
end. `--config` takes a solver
configuration in the benchmark's JSON form (portbench/configs/*.json): its
pressure-loop tolerances and caps and its CFL factor replace the kind's, so
that `--kind dfsph_padded_k5 --steps 144 --config
portbench/configs/dfsph_converged_f32.json` reaches the DFSPH cell's state.
`--shard K` (0 or 1) times the halo forms instead: the padded kind's grid
gets an even row count (`ny_multiple=2`, as a sharded run), and after the
steps shard K's rows of the one-device state, with its rows -1 and ny as the
halo (dead at the ends of the grid), go through K5's halo forms (in the
kind's math mode; the bf16 mode rebased on the shard's global rows) and K4's
halo form, through the same wrappers with a `planes.Halo`; every tree since
the sharded padded route has them. Beside them, `sm_rebucket_rows_alone` is
the one-device K4 on the shard's rows without the halo (the halo form's
yardstick: the same slots). Times are device milliseconds per call:
10 calls in a CUDA graph, CUDA events, median of 7. It calls only wrappers
and the scene API that every tree of the package since the padded K5 has, so
the same file times two trees in one run: put the other tree first on
PYTHONPATH and run this file by its path. `--save` writes each call's output
(and the state's positions and mask) with torch.save, a dict by kind, for a
bitwise comparison of two trees: `--compare` prints, for each kind and call
of two such files, whether they hold the same bits, and exits 1 if any
differ (no device needed). Timing needs a CUDA device; prints one JSON line a
kind.
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
    from yasph2d_tpu_torch.ops.slot_glue import tait_pressure
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


def padded_calls(solver, boundary, carry, rng) -> dict:
    """{label: (form, (query pos, mask), (source pos, mask), keyword operands)}
    of a padded step's pair calls (K3 or K5, by the solver's route) on
    `carry`; `stat` is the fluid -> boundary pass (K3's dfsph_stat, K5's
    dfsph_ctx)."""
    from yasph2d_tpu_torch.ops.slot_glue import tait_pressure

    dt = float(carry.time.dt)
    walls = (boundary.pos_pad, boundary.mask)
    if hasattr(carry, "ctx"):  # DFSPH
        f, ctx = solver._forms, carry.ctx
        mask = ctx.mask
        fluid = (ctx.pos_pad, mask)
        v = torch.where(mask[..., None], carry.v_pad + noise(rng, carry.v_pad, 0.5),
                        carry.v_pad)
        k = torch.where(mask, noise(rng, carry.kappa_pad, 50.0), 0.0)
        return {
            "ctx": (f.ctx, fluid, fluid, {}),
            "stat": (f.stat, fluid, walls, {}),
            "div": (f.div, fluid, fluid, dict(q_vals=(v,), s_vals=(v,))),
            "corr": (f.corr, fluid, fluid, dict(q_vals=(k,), s_vals=(k,))),
            "visc": (f.visc, fluid, fluid, dict(q_vals=(v,), s_vals=(v, ctx.densities_pad),
                                                scalars=(dt,))),
        }
    f, mask = solver._forms, carry.mask
    fluid = (carry.pos_pad, mask)
    dens = torch.where(mask, carry.dens_pad + noise(rng, carry.dens_pad, 5.0).abs(),
                       carry.dens_pad)
    v = torch.where(mask[..., None], carry.v_pad + noise(rng, carry.v_pad, 0.5), carry.v_pad)
    wv = (tait_pressure(solver.stiffness, solver.properties.fluid_density, dens), dens, v)
    return {
        "wcsph_density": (f.density, fluid, fluid, {}),
        "wcsph_stat": (f.stat, fluid, walls, {}),
        "wcsph_forces": (f.forces, fluid, fluid, dict(q_vals=wv, s_vals=wv, scalars=(dt,))),
    }


def _cpu(x):
    return x.cpu() if isinstance(x, torch.Tensor) else tuple(_cpu(y) for y in x)


def halo_rows(t, r0, r1):
    """Rows r0 - 1 and r1 of an (ny, nx, ...) slot tensor as (2, nx, ...), zero
    (dead) off the grid, as the ends of a mesh receive them."""
    rows = [t[r:r + 1] if 0 <= r < t.shape[0] else torch.zeros_like(t[:1])
            for r in (r0 - 1, r1)]
    return torch.cat(rows).contiguous()


def shard_call(call, r0: int, r1: int, ny: int):
    """A padded_calls entry on rows [r0, r1) of the grid, the source's rows
    r0 - 1 and r1 as its halo (`halo` keyword, a planes.Halo of ny global
    rows)."""
    from yasph2d_tpu_torch.ops.planes import Halo

    form, (qp, qm), (sp, sm), kw = call
    band = lambda t: t[r0:r1].contiguous()  # noqa: E731
    halo = Halo(tuple(halo_rows(t, r0, r1) for t in (sp, sm, *kw.get("s_vals", ()))), r0, ny)
    kb = {k: tuple(band(t) for t in v) if k in ("q_vals", "s_vals") else v
          for k, v in kw.items()}
    return form, (band(qp), band(qm)), (band(sp), band(sm)), dict(kb, halo=halo)


def rebucket_operands(solver, carry):
    """(advected positions, mask, payload parts) of the padded step's K4 call."""
    dt = float(carry.time.dt)
    if hasattr(carry, "ctx"):
        pos, mask = carry.ctx.pos_pad, carry.ctx.mask
        parts = (carry.v_pad, carry.kappa_pad, carry.stiff_pad)
    else:
        pos, mask, parts = carry.pos_pad, carry.mask, (carry.v_pad,)
    return pos + carry.v_pad * dt, mask, parts


def shard_rebucket(solver, carry, r0: int, r1: int) -> tuple:
    """K4's halo form on rows [r0, r1) of the padded step's advection and
    payload, the rows r0 - 1 and r1 as its halo, and the one-device K4 on the
    same rows alone (a grid of those rows, its origin moved up to row r0: the
    same slots without the halo, the halo form's yardstick); two functions of
    no argument."""
    import dataclasses

    from yasph2d_tpu_torch.ops import sm_rebucket as smr
    from yasph2d_tpu_torch.ops.planes import Halo

    adv, mask, parts = rebucket_operands(solver, carry)
    grid = solver.grid
    halo = Halo(tuple(halo_rows(t, r0, r1) for t in (mask, adv, *parts)), r0, grid.ny)
    band = tuple(t[r0:r1].contiguous() for t in (adv, mask, *parts))
    band_grid = dataclasses.replace(grid, ny=r1 - r0)
    alone = dataclasses.replace(band_grid, origin=(grid.origin[0],
                                                   grid.origin[1] + r0 * grid.cell_size))
    return (lambda: smr.sm_rebucket_parts(band[0], band[1], band[2:], band_grid, halo=halo),
            lambda: smr.sm_rebucket_parts(band[0], band[1], band[2:], alone))


def padded_rebucket(solver, carry):
    """K4 on the padded step's own advection and payload, with the glue the
    step of this tree puts around it; returns a function of no argument."""
    from yasph2d_tpu_torch.ops import sm_rebucket as smr

    grid = solver.grid
    adv, mask, parts = rebucket_operands(solver, carry)
    if hasattr(smr, "sm_rebucket_parts"):
        return lambda: smr.sm_rebucket_parts(adv, mask, parts, grid)

    def stacked():  # the step before the parts entry: concatenate, re-bucket, split
        values = parts[0] if len(parts) == 1 else torch.cat(
            [p if p.ndim == 4 else p[..., None] for p in parts], dim=-1)
        out = smr.sm_rebucket(adv, mask, values, grid)
        if len(parts) > 1:
            out = (*out[:2], (out[2][..., :2].contiguous(), out[2][..., 2].contiguous(),
                              out[2][..., 3].contiguous()), out[3])
        return out

    return stacked


def glue_calls(solver, boundary, carry) -> dict:
    """{name: (operands, slot mask)} of the padded WCSPH step's four glue
    calls (ops/slot_glue.py) on `carry`, each on the operands the step gives
    it: the kick-drift on the carry, the density and Tait pressure on the
    re-bucketed state's density and boundary passes, the accelerations and
    CFL max on its forces pass, the kick on those accelerations."""
    from yasph2d_tpu_torch.ops import slot_glue as sg
    from yasph2d_tpu_torch.ops.sm_rebucket import sm_rebucket_parts

    g, f = solver.grid, solver._forms
    dt = float(carry.time.dt)
    half = float(np.float32(0.5) * carry.time.dt)
    kick_drift = (carry.pos_pad, carry.v_pad, carry.accel_pad, carry.mask, half, dt)
    pos, v = sg.slot_kick_drift(*kick_drift)
    pos, mask, (v,), _ = sm_rebucket_parts(pos, carry.mask, (v,), g)
    fluid = (pos, mask)
    stat = solver._slot_pair(f.stat, *fluid, boundary.pos_pad, boundary.mask)
    density_tait = (solver._slot_pair(f.density, *fluid, *fluid)[..., 0], stat, mask,
                    float(solver.properties.particle_mass), solver._w0,
                    solver.properties.fluid_density, solver.stiffness,
                    not g.use_pallas_slotmajor)
    dens, pres = sg.slot_density_tait(*density_tait)
    wv = (pres, dens, v)
    accel_cfl = (solver._slot_pair(f.forces, *fluid, *fluid, q_vals=wv, s_vals=wv,
                                   scalars=(dt,)), stat, v, mask, solver.gravity, dt)
    accel = sg.slot_accel_cfl(*accel_cfl)[0]
    return {"slot_kick_drift": (kick_drift, carry.mask),
            "slot_density_tait": (density_tait, mask),
            "slot_accel_cfl": (accel_cfl, mask),
            "slot_kick": ((v, accel, mask, half), mask)}


def pressure_glue_calls(solver, carry) -> dict:
    """{record: (wrapper name, operands, slot mask)} of the pressure loops'
    glue calls (ops/pressure_glue.py) on a padded DFSPH `carry`, as a
    density-loop iteration makes them from the carry's velocities and warm
    start: the error in the density loop's mode and in the divergence
    loop's, the kick on the warm start's k. The wrapper updates k_sum and v
    in place (the operands' own tensors: repeated calls keep moving them)."""
    from yasph2d_tpu_torch.ops import pressure_glue as pg

    ctx, dt = carry.ctx, float(carry.time.dt)
    m = float(np.float32(solver.properties.particle_mass))
    rho0 = float(solver.properties.fluid_density)
    v, k = carry.v_pad.clone(), 0.5 * carry.kappa_pad
    div, dz = solver._div_pass(ctx, v), solver._dead_zero

    def err(rho, density):
        return ("slot_pressure_err", (div, v, ctx.sum_grad_stat, rho, ctx.alpha_pad,
                                      carry.kappa_pad.clone(), pg.loop_work(ctx.mask), ctx.mask,
                                      m, dt, rho0, density, dz), ctx.mask)

    return {"slot_pressure_err": err(ctx.densities_pad, True),
            "slot_pressure_err_divergence": err(ctx.neighbor_total, False),
            "slot_pressure_kick": ("slot_pressure_kick", (
                v, solver._corr_pass(ctx, k), k, ctx.sum_grad_stat, ctx.mask,
                float(np.float32(1.0) / np.float32(dt) * np.float32(m)), dz), ctx.mask)}


def gated_calls(solver, carry, pg) -> dict:
    """{label: function of no argument} of a pressure-loop iteration's four
    loop launches (ops/pressure_glue.py `pg`) on a padded DFSPH `carry`,
    each gated off (the loop's last iteration 0, the launch's 1): K5's or
    K3's div and corr passes and the two glue kernels. Each call builds its
    launcher, on the stream it runs on."""
    ctx, route, forms = carry.ctx, solver._route, solver._forms
    mask, pos = ctx.mask, ctx.pos_pad
    calls = pressure_glue_calls(solver, carry)
    err, kick = calls["slot_pressure_err"][1], calls["slot_pressure_kick"][1]
    buffers = pg.loop_buffers(err[6], mask)
    test = pg.ExitTest(float(np.float32(int(mask.sum()))), 1e-8, 200)
    mode = {} if route.rebase is None else dict(rebase=route.rebase)

    def pair(form, vals):
        out = torch.empty(mask.shape + (form.n_out,), device=mask.device)
        return lambda: route.loop_launcher(form, pos, mask, pos, mask, solver._consts, (vals,),
                                           (vals,), out, buffers[1], **mode)(1)

    return {"gated_div": pair(forms.div, err[1]), "gated_corr": pair(forms.corr, kick[2]),
            "gated_slot_pressure_err": lambda: pg.err_launcher(*err, buffers, test)(1),
            "gated_slot_pressure_kick": lambda: pg.kick_launcher(*kick, buffers[1])(1)}


def pressure_glue_check(name: str, operands) -> tuple:
    """(kernel call, twin call, equal) of pressure glue kernel `name` on
    `operands`: the kernel on copies of the tensors it updates in place
    against the twin, every slot of every output bit for bit, and
    slot_pressure_err's total within 1e-6 of the twin's (it sums in an
    order of its own); the kernel call it returns updates the operands' own
    tensors."""
    from yasph2d_tpu_torch.ops import pressure_glue as pg

    kernel = lambda: getattr(pg, name)(*operands)  # noqa: E731
    twin = lambda: getattr(pg, name.replace("slot_", "") + "_ref")(*operands)  # noqa: E731
    fresh = list(operands)
    for i in ((0,) if name == "slot_pressure_kick" else (5, 6)):  # v; k_sum, work
        if fresh[i] is not None:
            fresh[i] = fresh[i].clone()
    got, ref = getattr(pg, name)(*fresh), twin()
    if name == "slot_pressure_kick":
        return kernel, twin, _same_bits(got, ref)
    total, ref_total = float(got[2]), float(ref[2])
    return kernel, twin, (_same_bits(got[:2], ref[:2])
                          and abs(total - ref_total) <= 1e-6 * abs(ref_total))


def glue_check(name: str, operands, mask) -> tuple:
    """(kernel call, twin call, bit-equal) of glue kernel `name` on
    `operands`: every output's bits, slot_kick_drift's live slots only (it
    writes no other)."""
    from yasph2d_tpu_torch.ops import slot_glue as sg

    kernel = lambda: getattr(sg, name)(*operands)  # noqa: E731
    twin = lambda: getattr(sg, name.removeprefix("slot_") + "_ref")(*operands)  # noqa: E731
    got, ref = kernel(), twin()
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    if name == "slot_kick_drift":
        got, ref = [t[mask] for t in got], [t[mask] for t in ref]
    return kernel, twin, _same_bits(tuple(got), tuple(ref))


def probe_runs(device) -> tuple:
    """({label: function of no argument}, the planes) of K7 at the probe's
    check and gpu shapes and of K1 ctx at the gpu shape."""
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc

    runs, planes = {}, {}
    for label, d in (("probe_ctx_check", pc.CHECK_SHAPE), ("probe_ctx", pc.GPU_SHAPE)):
        q = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"]), device)
        runs[label] = (lambda q=q, d=d: pc.ctx_pass(q, q, d["h"], d["m"]))
        planes[label] = q
    d = pc.GPU_SHAPE
    runs["k1_ctx"] = pc.k1_ctx_call(planes["probe_ctx"], planes["probe_ctx"], d["h"], d["m"])
    return runs, planes["probe_ctx"]


def kind_runs(kind, args, device) -> tuple:
    """({label: function of no argument}, (positions, mask) of the state, the
    per-step (density iterations, divergence iterations, drops)) of one kind:
    its step's kernel calls on the state after `args.steps` steps (shard
    `args.shard`'s halo forms if set)."""
    from yasph2d_tpu_torch.ops.pair_reduce import pair_reduce
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    slot = "padded" in kind or "dense" in kind
    if args.shard is not None and "padded" not in kind:
        raise SystemExit(f"kernel_times: --shard needs a padded kind, not {kind}")
    world = double_dam_break(args.particles)
    solver, boundary = bench_solver(kind, world, device=device,
                                    **({} if args.shard is None else dict(ny_multiple=2)))
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    per_step, gated = [], {}
    if getattr(args, "config", None):
        solver = configured(solver, args.config)
    try:  # the padded WCSPH step's glue kernels; a tree before them has none
        from yasph2d_tpu_torch.ops import slot_glue as glue
    except ImportError:
        glue = None
    try:  # the DFSPH pressure loops' glue kernels; a tree before them has none
        from yasph2d_tpu_torch.ops import pressure_glue
    except ImportError:
        pressure_glue = None
    glue_before = dict(glue.LAUNCHES) if glue else {}
    if pressure_glue:
        glue_before.update(pressure_glue.LAUNCHES)
    for _ in range(args.steps):
        carry, d = solver.simulate(carry, boundary, 1)
        per_step.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    if device.type == "cuda":
        torch.cuda.synchronize()
    c = solver._consts
    rng = np.random.default_rng(0)
    runs, records = {}, {}
    if slot:
        from yasph2d_tpu_torch.models.slot_solver import pair_route

        calls = padded_calls(solver, boundary, carry, rng)
        state = (carry.ctx.pos_pad, carry.ctx.mask) if hasattr(carry, "ctx") \
            else (carry.pos_pad, carry.mask)
        r0 = 0
        if args.shard is not None:  # shard k of two: its rows, the halo forms
            ny = solver.grid.ny
            r0, r1 = args.shard * ny // 2, (args.shard + 1) * ny // 2
            calls = {label: shard_call(call, r0, r1, ny) for label, call in calls.items()}
            state = tuple(t[r0:r1] for t in state)
        route = pair_route(solver.grid, r0)
        pair = route.reduce
        mode = {} if route.rebase is None else dict(rebase=route.rebase)  # K5's bf16 mode
        for label, (form, q, s, kw) in calls.items():
            kw = dict(kw, **mode)
            runs[label] = (lambda form=form, q=q, s=s, kw=kw: pair(form, *q, *s, c, **kw))
        if "padded" in kind and args.shard is None:
            runs["sm_rebucket"] = padded_rebucket(solver, carry)
            if glue is not None and not hasattr(carry, "ctx"):
                # the WCSPH glue kernels, apart from `runs`: slot_kick_drift
                # leaves dead slots unwritten, which --save would compare
                from yasph2d_tpu_torch.tools.roofline import bound, glue_bytes

                for name, (operands, live) in glue_calls(solver, boundary, carry).items():
                    kernel, twin, equal = glue_check(name, operands, live)
                    n_bytes = glue_bytes(name, live, name == "slot_density_tait"
                                         and not operands[-1])
                    records[name] = dict(
                        kernel=kernel, twin=twin, bytes=n_bytes, bound_ms=bound(n_bytes, 0)[0],
                        bit_equal=equal, launches_per_step=(
                            glue.LAUNCHES[name] - glue_before[name]) / max(args.steps, 1))
            if pressure_glue is not None and hasattr(carry, "ctx"):
                from yasph2d_tpu_torch.tools.roofline import bound, pressure_glue_bytes

                for label, (name, operands, live) in pressure_glue_calls(solver, carry).items():
                    kernel, twin, equal = pressure_glue_check(name, operands)
                    n_bytes = pressure_glue_bytes(name, live, operands[-1])
                    records[label] = dict(
                        kernel=kernel, twin=twin, bytes=n_bytes, bound_ms=bound(n_bytes, 0)[0],
                        bit_equal=equal, launches_per_step=(
                            pressure_glue.LAUNCHES[name] - glue_before[name])
                        / max(args.steps, 1))
                if hasattr(pressure_glue, "err_launcher"):
                    gated = gated_calls(solver, carry, pressure_glue)
        elif "padded" in kind:
            runs["sm_rebucket"], runs["sm_rebucket_rows_alone"] = shard_rebucket(
                solver, carry, r0, r1)
    else:
        from yasph2d_tpu_torch.ops.rebucket import rebucket

        for label, (form, q, s, kw) in plane_calls(solver, boundary, carry, rng).items():
            runs[label] = (lambda form=form, q=q, s=s, kw=kw: pair_reduce(form, q, s, c, **kw))
        if hasattr(carry, "ctx"):
            mask, pos = carry.ctx.mask, carry.ctx.pos
            values = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]])
        else:
            mask, pos = carry.mask, carry.pos
            values = carry.v.contiguous()
        adv = pos + carry.v * float(carry.time.dt)
        runs["rebucket"] = lambda: rebucket(adv, mask, values, solver.grid)
        state = (pos, mask)
    return runs, state, per_step, records, gated


def configured(solver, path):
    """`solver` with the pressure-loop tolerances and caps and the CFL
    factor of the solver configuration at `path` (the benchmark's JSON
    form)."""
    import dataclasses

    with open(path) as f:
        cfg = json.load(f)
    knobs = {k: v for k, v in cfg["solver"].items() if k.startswith("max_")}
    return dataclasses.replace(solver, **knobs, step_config=dataclasses.replace(
        solver.step_config, cfl_factor=cfg["timestep"]["cfl_factor"]))


def _same_bits(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                b.view(torch.int32) if b.dtype == torch.float32 else b))
    return len(a) == len(b) and all(_same_bits(x, y) for x, y in zip(a, b))


def compare(old_path, new_path) -> bool:
    """Print, for each kind and call of two `--save` files, whether they hold
    the same bits (floats compared as their bit patterns); True if all do."""
    old, new = torch.load(old_path), torch.load(new_path)
    ok = set(old) == set(new)
    for kind in sorted(set(old) & set(new)):
        a, b = old[kind], new[kind]
        calls = {label: label in b["outputs"] and _same_bits(out, b["outputs"][label])
                 for label, out in a["outputs"].items()}
        state = _same_bits(a["state"], b["state"])
        ok &= state and all(calls.values()) and set(a["outputs"]) == set(b["outputs"])
        print(f"{kind}: state {'=' if state else 'DIFFERS'} " + " ".join(
            f"{label}{'=' if same else ':DIFFERS'}" for label, same in calls.items()))
    print("all bitwise equal" if ok else "outputs differ")
    return ok


def main(argv=None):
    from yasph2d_tpu_torch.utils.cuda_timing import event_ms, graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="dfsph_plane_bf16")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--shard", type=int, choices=(0, 1), default=None,
                    help="time the halo forms on this shard's rows (of two)")
    ap.add_argument("--save", default=None, help="torch.save each call's output here")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"), default=None,
                    help="compare two --save files bit for bit")
    ap.add_argument("--config", default=None,
                    help="a solver configuration (JSON) whose loop knobs and CFL replace "
                         "the kind's")
    args = ap.parse_args(argv)
    if args.compare:
        raise SystemExit(0 if compare(*args.compare) else 1)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA device")
    device = torch.device("cuda", 0)

    saved = {}
    for kind in args.kind.split(","):
        if kind == "probe_ctx":
            runs, q = probe_runs(device)
            if args.save:
                saved[kind] = {"state": _cpu((q,)),
                               "outputs": {label: _cpu(run()) for label, run in runs.items()}}
            times = {label: graph_ms(run) for label, run in runs.items()}
            print(json.dumps({"kind": kind, "live": int((q[2] > 0).sum()),
                              "device": torch.cuda.get_device_name(0), "ms": times}), flush=True)
            continue
        runs, state, per_step, records, gated = kind_runs(kind, args, device)
        if args.save:
            saved[kind] = {"state": _cpu(state),
                           "outputs": {label: _cpu(run()) for label, run in runs.items()}}
        times = {label: graph_ms(run) for label, run in runs.items()}
        glue = {name: dict(ms=graph_ms(r.pop("kernel")), twin_ms=event_ms(r.pop("twin")), **r)
                for name, r in records.items()}
        print(json.dumps({"kind": kind, "particles": args.particles, "steps": args.steps,
                          "shard": args.shard, "live": int(state[1].sum()),
                          "device": torch.cuda.get_device_name(0),
                          "iterations_drops_per_step": per_step, "ms": times,
                          **({"glue": glue} if glue else {}),
                          **({"gated": {label: graph_ms(run) for label, run in gated.items()}}
                             if gated else {})}), flush=True)
    if args.save:
        torch.save(saved, args.save)


if __name__ == "__main__":
    main()
