"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels (yasph2d_tpu_torch/csrc) with nvcc;
  3. kernels: on the 100k double dam-break state, each of the six call forms of
     the pair kernel and the re-bucket kernel against its plain PyTorch twin on
     the same CUDA tensors (pair forms to rtol 1e-5 plus 1e-6 of the plane's
     scale; re-bucket bit-equal, with and without forced cell overflow), and
     their times (CUDA events, median of several runs);
  4. small reference: a 3k-particle scene stepped through the kernels on the
     GPU and through the twins on the CPU must agree;
  5. main path: init_carry + 20 DFSPH steps of the 100k double dam-break through
     the kernels, with every kernel's launch count > 0, no dropped particle, all
     99,372 particles live, finite state and densities in [rho0, 1.3 rho0].

The line before the last is the GPU's name and power limit as nvidia-smi
reports them, the one before that the per-kernel JSON record; the last line is
{"ok": true, "device": ...}. Any failed phase raises, exits non-zero and
prints no result. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import time

import numpy as np
import torch

STEPS = 20
N_FLUID = 99_372
REPEATS = 7
PAIR_SOURCE = "yasph2d_tpu_torch/csrc/pair_reduce.cu"
REBUCKET_SOURCE = "yasph2d_tpu_torch/csrc/rebucket.cu"
PAIR_REPLACES = "yasph2d_tpu/ops/pallas_slotmajor.py:821"  # pf_pair_reduce
REBUCKET_REPLACES = "yasph2d_tpu/ops/pallas_slotmajor.py:1120"  # pf_rebucket


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats=REPEATS) -> float:
    """Median milliseconds of one call, each timed with CUDA events after a
    warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_solver(world, device):
    from yasph2d_tpu_torch import AdaptiveTimeStep, DFSPHPlaneSolver, XSPHViscosityModel

    grid = world.dense_grid(occupancy=7)
    solver = DFSPHPlaneSolver(
        viscosity_model=XSPHViscosityModel(
            smoothing_length=world.properties.smoothing_length
        ),
        properties=world.properties,
        grid=grid,
        step_config=AdaptiveTimeStep(
            timestep_max=1.0 / 360.0, timestep_min=1.0 / 24000.0, cfl_factor=1.5
        ),
    )
    boundary = solver.boundary_planes(world.boundary_dense(grid, device=device))
    return solver, boundary


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("phase 1 environment: FAILED, torch.cuda.is_available() is false")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
    nvcc_version = (nvcc.stdout.strip().splitlines() or ["nvcc not found"])[-1]
    log(f"phase 1 environment: {gpu_line()} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {nvcc_version} | "
        f"devices {torch.cuda.device_count()}")


def phase_build():
    from yasph2d_tpu_torch.ops import cuda_build

    fresh = not cuda_build.library_path().exists()
    t0 = time.perf_counter()
    path = cuda_build.build()
    t_build = time.perf_counter() - t0
    cuda_build.library()
    log(f"phase 2 build: {path.name} {'nvcc' if fresh else 'already built,'} "
        f"{t_build:.2f} s, load {time.perf_counter() - t0 - t_build:.2f} s")


def pair_error(kernel_out, twin_out, mask):
    """(max abs error on live slots, passes the stated tolerance)."""
    live = mask.expand_as(kernel_out)
    a, b = kernel_out[live], twin_out[live]
    err = (a - b).abs()
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    ok = bool(torch.isfinite(a).all()) and bool((err <= 1e-5 * b.abs() + 1e-6 * scale).all())
    return float(err.max()) if err.numel() else 0.0, ok


def phase_kernels(device):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb
    from yasph2d_tpu_torch.ops.cuda_build import PAIR_FORMS
    from yasph2d_tpu_torch.scenes import double_dam_break

    world = double_dam_break(100_000)
    solver, boundary = build_solver(world, device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, 3)  # a state in motion
    torch.cuda.synchronize()
    ctx = carry.ctx
    geom = ctx.geom
    dt = float(carry.time.dt)
    m = np.float32(solver.properties.particle_mass)
    scale = float((np.float32(1.0) / np.float32(dt)) * m)
    f = solver._forms
    # (label, form, source geometry, keyword operands) as the step calls them.
    # Early in the dam break no fluid slot is within h of the boundary, so the
    # fluid -> boundary call sums nothing; the same instantiation is also
    # checked fluid -> fluid, where every live slot has neighbours.
    stat = pr.pair_reduce(f.ctx, geom, boundary.geom, solver._consts)
    # the falling lattice barely compresses yet and every slot has fewer than
    # the 9 neighbours the divergence guard asks for: seeded velocity,
    # stiffness and neighbour-count noise makes the loop forms do real work
    rng = np.random.default_rng(0)
    nt = torch.as_tensor(
        np.floor(rng.uniform(0.0, 18.0, tuple(ctx.neighbor_total.shape))).astype(np.float32),
        device=device)
    v = carry.v + torch.as_tensor(
        rng.normal(0.0, 0.5, tuple(carry.v.shape)).astype(np.float32), device=device)
    k = torch.as_tensor(
        rng.normal(0.0, 50.0, tuple(carry.kappa.shape)).astype(np.float32), device=device)
    calls = [
        ("ctx", f.ctx, boundary.geom, {}),
        ("ctx[fluid->fluid]", f.ctx, geom, {}),
        ("ctx_post", f.ctx_post, geom, dict(post_planes=(stat,))),
        ("visc_gravity", f.visc_gravity, geom, dict(
            q_vals=(v,), s_vals=(v, ctx.densities), scalars=(dt,))),
        ("err_ki", f.err_ki, geom, dict(
            q_vals=(v,), s_vals=(v,), scalars=(dt,),
            post_planes=(v, ctx.sum_grad_stat, ctx.densities, ctx.alpha))),
        ("delta_ki", f.delta_ki, geom, dict(
            q_vals=(v,), s_vals=(v,),
            post_planes=(v, ctx.sum_grad_stat, nt, ctx.alpha))),
        ("corr_v", f.corr_v, geom, dict(
            q_vals=(k,), s_vals=(k,), scalars=(scale,),
            post_planes=(v, k, ctx.sum_grad_stat))),
    ]
    records = {}
    nonzero_forms = set()
    for label, form, src, kw in calls:
        def kernel():
            return pr.pair_reduce(form, geom, src, solver._consts, **kw)

        def twin():
            return pr.pair_reduce_ref(
                form.term_fn, form.n_out, geom, src, solver._consts.radius_sq,
                post_fn=form.post_fn, n_acc=form.n_acc, **kw)

        out_k, out_t = kernel(), twin()
        torch.cuda.synchronize()
        err, ok = pair_error(out_k, out_t, ctx.mask)
        nonzero = bool(out_t[ctx.mask.expand_as(out_t)].abs().sum() > 0)
        if nonzero:
            nonzero_forms.add(form.name)
        ms, plain_ms = cuda_ms(kernel), cuda_ms(twin)
        log(f"phase 3 kernels: pair_reduce_{label} max_abs_err {err!r} "
            f"{'ok' if ok else 'MISMATCH'} nonzero {nonzero} "
            f"kernel {ms:.4f} ms twin {plain_ms:.4f} ms")
        if not ok:
            raise RuntimeError(f"pair_reduce_{label} disagrees with its twin "
                               f"(max_abs_err {err})")
        name = f"pair_reduce_{form.name}"
        if name in records:  # keep the main-path call's times
            records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        else:
            records[name] = dict(name=name, route="cuda", source=PAIR_SOURCE,
                                 replaces=PAIR_REPLACES, max_abs_err=err, ms=ms,
                                 plain_ms=plain_ms)
    idle = set(PAIR_FORMS) - nonzero_forms
    if idle:
        raise RuntimeError(f"pair forms never produced a nonzero live output: {idle}")
    records = list(records.values())

    # re-bucket: the step's own advection, and a forced overflow in which every
    # particle of an odd cell column moves one cell left
    grid = solver.grid
    pos = ctx.pos + carry.v * dt
    extra = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]], dim=0)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[0] -= odd * grid.cell_size
    rb_ms = rb_plain_ms = None
    for name, p in (("advect", pos), ("overflow", crowded)):
        out_k = rb.rebucket(p, ctx.mask, extra, grid)
        out_t = rb.rebucket_ref(p, ctx.mask, extra, grid)
        torch.cuda.synchronize()
        equal = all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                b.view(torch.int32) if b.dtype == torch.float32 else b)
                    for a, b in zip(out_k, out_t))
        drops = int(out_k[3])
        log(f"phase 3 kernels: rebucket[{name}] bit-equal {equal} drops {drops} "
            f"live {int(out_k[1].sum())}")
        if not equal:
            raise RuntimeError(f"rebucket[{name}] is not bit-equal to its twin")
        if name == "overflow" and drops == 0:
            raise RuntimeError("rebucket[overflow] forced no drops")
        if name == "advect":
            if drops != 0:
                raise RuntimeError("rebucket[advect] dropped particles")
            rb_ms = cuda_ms(lambda: rb.rebucket(p, ctx.mask, extra, grid))
            rb_plain_ms = cuda_ms(lambda: rb.rebucket_ref(p, ctx.mask, extra, grid))
    log(f"phase 3 kernels: rebucket kernel {rb_ms:.4f} ms twin {rb_plain_ms:.4f} ms")
    records.append(dict(name="rebucket", route="cuda", source=REBUCKET_SOURCE,
                        replaces=REBUCKET_REPLACES, max_abs_err=0.0, ms=rb_ms,
                        plain_ms=rb_plain_ms))
    return records


def live_rows(state):
    alive = state.alive
    rows = torch.cat([state.positions, state.densities[:, None]], dim=1)[alive]
    rows = rows.cpu().numpy()
    return rows[np.lexsort(rows.T)]


def phase_small_reference(device):
    """Kernels on the GPU against the twins on the CPU, 5 steps of a 3k scene."""
    from yasph2d_tpu_torch.scenes import double_dam_break

    runs = {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        solver, boundary = build_solver(world, dev)
        carry = solver.init_carry(world.initial_state(device=dev), boundary)
        iters = []
        for _ in range(5):
            carry, d = solver.simulate(carry, boundary, 1)
            iters.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
        runs[dev.type] = (iters, live_rows(solver.export_state(carry)))
    (gi, grows), (ci, crows) = runs["cuda"], runs["cpu"]
    diff = float(np.abs(grows - crows).max())
    log(f"phase 4 small reference: {grows.shape[0]} particles, iterations "
        f"gpu {gi} cpu {ci}, max row diff {diff!r}")
    if gi != ci or grows.shape != crows.shape or not np.allclose(
            grows, crows, rtol=1e-5, atol=1e-5):
        raise RuntimeError("GPU kernels and CPU twins disagree on the small scene")


def phase_main_path(device):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb
    from yasph2d_tpu_torch.scenes import double_dam_break

    world = double_dam_break(100_000)
    assert world.num_dynamic_particles == N_FLUID, world.num_dynamic_particles
    solver, boundary = build_solver(world, device)
    grid = solver.grid
    state = world.initial_state(device=device)
    torch.cuda.synchronize()

    pr.reset_launch_counts()
    rb.reset_launch_counts()
    t0 = time.perf_counter()
    carry = solver.init_carry(state, boundary)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    diags = []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, d = solver.simulate(carry, boundary, 1)
        diags.append(d)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {f"pair_reduce_{k}": v for k, v in pr.LAUNCHES.items()}
    launches["rebucket"] = rb.LAUNCHES["rebucket"]

    s = solver.export_state(carry)
    live = int(s.alive.sum())
    rho0 = solver.properties.fluid_density
    pos, vel, dens = s.positions[s.alive], s.velocities[s.alive], s.densities[s.alive]
    finite = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()
                  and torch.isfinite(dens).all())
    dmin, dmax = float(dens.min()), float(dens.max())
    drops = max(d.neighbor_drops for d in diags)
    iters = [(d.density_iterations, d.divergence_iterations) for d in diags]
    ms = elapsed / STEPS * 1e3
    log(f"phase 5 main path: grid {grid.nx}x{grid.ny} P {grid.occupancy}, "
        f"{live} live / {world.num_boundary_particles} boundary, init {t_init:.3f} s, "
        f"{STEPS} steps {ms:.3f} ms/step {live * STEPS / elapsed:.1f} particle-steps/s, "
        f"drops {drops}, density [{dmin!r}, {dmax!r}], dt {float(carry.time.dt)!r}")
    log(f"phase 5 main path: iterations per step (density, divergence) {iters}")
    log(f"phase 5 main path: launches {launches}")
    problems = [k for k, v in launches.items() if v <= 0]
    if problems:
        raise RuntimeError(f"kernels never launched on the main path: {problems}")
    if drops != 0 or live != N_FLUID or not finite:
        raise RuntimeError(f"main path state wrong: drops {drops} live {live} "
                           f"finite {finite}")
    if not (rho0 <= dmin and dmax <= 1.3 * rho0):
        raise RuntimeError(f"densities outside [rho0, 1.3 rho0]: [{dmin}, {dmax}]")
    return launches


def main():
    phase_environment()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    records = phase_kernels(device)
    phase_small_reference(device)
    launches = phase_main_path(device)
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
