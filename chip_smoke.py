"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels (yasph2d_tpu_torch/csrc) with nvcc;
  3. kernels: each kernel against its plain PyTorch twin on the same CUDA
     tensors, at the 100k double dam-break shapes after 3 steps: the nine call
     forms of the pair kernel K1 and the re-bucket K2 on the plane states of
     the DFSPH and WCSPH steps, the three forms of the slot-major pair kernel
     K3 and the slot-major re-bucket K4 on the padded WCSPH state. Pair forms
     agree to rtol 1e-5 plus 1e-6 of the plane's scale; the re-buckets
     bit-equal, with and without forced cell overflow. Times are CUDA events,
     median of several runs;
  4. small reference: a 3k-particle scene stepped through the kernels on the
     GPU and through the twins on the CPU must agree (DFSPH and both WCSPH
     solvers);
  5. main path: init_carry + 20 steps of the 100k double dam-break through the
     kernels, for the DFSPH plane solver and each WCSPH solver, with the launch
     count of every kernel of that path > 0, no dropped particle, all 99,372
     particles live, finite state and densities in [rho0, 1.3 rho0].

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
WARMUP_STEPS = 3
CSRC = "yasph2d_tpu_torch/csrc/"
SOURCES = {
    "pair_reduce": CSRC + "pair_reduce.cu",
    "rebucket": CSRC + "rebucket.cu",
    "sm_pair_reduce": CSRC + "sm_pair_reduce.cu",
    "sm_rebucket": CSRC + "sm_rebucket.cu",
}
REPLACES = {
    "pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:821",  # pf_pair_reduce
    "rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1120",  # pf_rebucket
    "sm_pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:252",  # sm_pair_reduce
    "sm_rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1263",  # sm_rebucket
}
DFSPH_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v")
WCSPH_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces")
# the kernels each main path must launch
PATHS = {
    "dfsph_plane": [f"pair_reduce_{f}" for f in DFSPH_FORMS] + ["rebucket"],
    "wcsph_padded": [f"sm_pair_reduce_{f}" for f in WCSPH_FORMS] + ["sm_rebucket"],
    "wcsph_plane": [f"pair_reduce_{f}" for f in WCSPH_FORMS] + ["rebucket"],
}


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


def build_solver(kind, world, device):
    """(solver, boundary) of one main path, as a user builds them."""
    from yasph2d_tpu_torch import (
        AdaptiveTimeStep, DFSPHPlaneSolver, WCSPHPaddedSolver, WCSPHPlaneSolver,
        XSPHViscosityModel,
    )

    cls = {"dfsph_plane": DFSPHPlaneSolver, "wcsph_padded": WCSPHPaddedSolver,
           "wcsph_plane": WCSPHPlaneSolver}[kind]
    grid = world.dense_grid(occupancy=7)
    solver = cls(
        viscosity_model=XSPHViscosityModel(
            smoothing_length=world.properties.smoothing_length
        ),
        properties=world.properties,
        grid=grid,
        # WCSPH runs the reference's tighter CFL (bench.py:116-120)
        step_config=AdaptiveTimeStep(
            timestep_max=1.0 / 360.0, timestep_min=1.0 / 24000.0,
            cfl_factor=0.2 if kind.startswith("wcsph") else 1.5,
        ),
    )
    boundary = world.boundary_dense(grid, device=device)
    if kind != "wcsph_padded":
        boundary = solver.boundary_planes(boundary)
    return solver, boundary


def moving_state(kind, device):
    """A 100k state in motion: init_carry + a few steps."""
    from yasph2d_tpu_torch.scenes import double_dam_break

    world = double_dam_break(100_000)
    solver, boundary = build_solver(kind, world, device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, WARMUP_STEPS)
    torch.cuda.synchronize()
    return solver, boundary, carry


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


def pair_error(kernel_out, twin_out, live):
    """(max abs error on live slots, passes the stated tolerance)."""
    a, b = kernel_out[live], twin_out[live]
    err = (a - b).abs()
    scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
    ok = bool(torch.isfinite(a).all()) and bool((err <= 1e-5 * b.abs() + 1e-6 * scale).all())
    return float(err.max()) if err.numel() else 0.0, ok


def bit_equal(outs_k, outs_t) -> bool:
    def bits(a):
        return a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(outs_k, outs_t))


class Records:
    """The per-kernel JSON records; a kernel checked in several calls keeps
    the first (main-path) call's times and the largest error."""

    def __init__(self):
        self.by_name = {}
        self.nonzero = set()

    def add(self, name, kernel, max_abs_err, ms, plain_ms):
        if name in self.by_name:
            rec = self.by_name[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err)
            return
        self.by_name[name] = dict(name=name, route="cuda", source=SOURCES[kernel],
                                  replaces=REPLACES[kernel], max_abs_err=max_abs_err,
                                  ms=ms, plain_ms=plain_ms)

    def check_pair(self, kernel, label, form, run_kernel, run_twin, live):
        out_k, out_t = run_kernel(), run_twin()
        torch.cuda.synchronize()
        err, ok = pair_error(out_k, out_t, live)
        nonzero = bool(out_t[live].abs().sum() > 0)
        name = f"{kernel}_{form.name}"
        if nonzero:
            self.nonzero.add(name)
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_twin)
        log(f"phase 3 kernels: {kernel}_{label} max_abs_err {err!r} "
            f"{'ok' if ok else 'MISMATCH'} nonzero {nonzero} "
            f"kernel {ms:.4f} ms twin {plain_ms:.4f} ms")
        if not ok:
            raise RuntimeError(f"{kernel}_{label} disagrees with its twin "
                               f"(max_abs_err {err})")
        self.add(name, kernel, err, ms, plain_ms)

    def check_rebucket(self, kernel, label, run_kernel, run_twin, overflow):
        out_k, out_t = run_kernel(), run_twin()
        torch.cuda.synchronize()
        equal = bit_equal(out_k, out_t)
        drops = int(out_k[3])
        log(f"phase 3 kernels: {kernel}[{label}] bit-equal {equal} drops {drops} "
            f"live {int(out_k[1].sum())}")
        if not equal:
            raise RuntimeError(f"{kernel}[{label}] is not bit-equal to its twin")
        if overflow and drops == 0:
            raise RuntimeError(f"{kernel}[{label}] forced no drops")
        if not overflow:
            if drops != 0:
                raise RuntimeError(f"{kernel}[{label}] dropped particles")
            ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_twin)
            log(f"phase 3 kernels: {kernel} kernel {ms:.4f} ms twin {plain_ms:.4f} ms")
            self.add(kernel, kernel, 0.0, ms, plain_ms)

    def require_nonzero(self, names):
        idle = set(names) - self.nonzero
        if idle:
            raise RuntimeError(f"pair forms never produced a nonzero live output: {idle}")


def phase_kernels_dfsph(device, rec: Records):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb

    solver, boundary, carry = moving_state("dfsph_plane", device)
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
    live = ctx.mask
    for label, form, src, kw in calls:
        rec.check_pair(
            "pair_reduce", label, form,
            lambda: pr.pair_reduce(form, geom, src, solver._consts, **kw),
            lambda: pr.pair_reduce_ref(
                form.term_fn, form.n_out, geom, src, solver._consts.radius_sq,
                post_fn=form.post_fn, n_acc=form.n_acc, **kw),
            live.expand(form.n_out, *live.shape))
    rec.require_nonzero([f"pair_reduce_{n}" for n in DFSPH_FORMS])

    # re-bucket: the step's own advection, and a forced overflow in which every
    # particle of an odd cell column moves one cell left
    grid = solver.grid
    pos = ctx.pos + carry.v * dt
    extra = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]], dim=0)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[0] -= odd * grid.cell_size
    for label, p in (("advect", pos), ("overflow", crowded)):
        rec.check_rebucket("rebucket", label,
                           lambda: rb.rebucket(p, ctx.mask, extra, grid),
                           lambda: rb.rebucket_ref(p, ctx.mask, extra, grid),
                           overflow=label == "overflow")


def wcsph_operands(solver, live, v_live, v, dens, rng):
    """Forces-pass operands of a WCSPH state: the barely compressed early state
    has rho = rho0 and p = 0 everywhere, so seeded density (up) and velocity
    noise on live slots gives the pressure and viscosity terms real work."""
    from yasph2d_tpu_torch.models.wcsph import tait_pressure

    def noise(t, scale):
        return torch.as_tensor(rng.normal(0.0, scale, tuple(t.shape)).astype(np.float32),
                               device=t.device)

    rho0 = solver.properties.fluid_density
    dens = torch.where(live, dens + noise(dens, 0.05 * rho0).abs(), dens)
    v = torch.where(v_live, v + noise(v, 0.5), v)
    return tait_pressure(solver.stiffness, rho0, dens), dens, v


def phase_kernels_wcsph(device, rec: Records):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.ops import sm_rebucket as smr
    from yasph2d_tpu_torch.ops.planes import PlaneGeom

    rng = np.random.default_rng(1)

    # K3 and K4 on the padded state
    solver, boundary, carry = moving_state("wcsph_padded", device)
    f, c, grid = solver._forms, solver._consts, solver.grid
    dt = float(carry.time.dt)
    pos, mask = carry.pos_pad, carry.mask
    pres, dens, v = wcsph_operands(solver, mask, mask[..., None], carry.v_pad,
                                   carry.dens_pad, rng)
    fluid = (pos, mask)
    walls = (boundary.pos_pad, boundary.mask)
    calls = [
        ("wcsph_density", f.density, fluid, {}),
        ("wcsph_stat", f.stat, walls, {}),
        # the fluid -> boundary pass sums nothing before the columns reach the
        # walls: the same instantiation fluid -> fluid
        ("wcsph_stat[fluid->fluid]", f.stat, fluid, {}),
        ("wcsph_forces", f.forces, fluid, dict(
            q_vals=(pres, dens, v), s_vals=(pres, dens, v), scalars=(dt,))),
    ]
    for label, form, (s_pos, s_mask), kw in calls:
        rec.check_pair(
            "sm_pair_reduce", label, form,
            lambda: smp.sm_pair_reduce(form, pos, mask, s_pos, s_mask, c, **kw),
            lambda: smp.sm_pair_reduce_ref(form.term_fn, form.n_out, pos, mask, s_pos,
                                           s_mask, c.radius_sq, **kw),
            mask[..., None].expand(*mask.shape, form.n_out))
    rec.require_nonzero([f"sm_pair_reduce_{n}" for n in WCSPH_FORMS])
    adv = pos + carry.v_pad * dt
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = adv.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    for label, p in (("advect", adv), ("overflow", crowded)):
        rec.check_rebucket("sm_rebucket", label,
                           lambda: smr.sm_rebucket(p, mask, carry.v_pad, grid),
                           lambda: smr.sm_rebucket_ref(p, mask, carry.v_pad, grid),
                           overflow=label == "overflow")

    # K1's WCSPH forms and K2 with the velocity payload on the plane state
    solver, boundary, carry = moving_state("wcsph_plane", device)
    f, c = solver._forms, solver._consts
    dt = float(carry.time.dt)
    geom = PlaneGeom(carry.pos, carry.mask)
    pres, dens, v = wcsph_operands(solver, carry.mask, carry.mask[None], carry.v,
                                   carry.dens, rng)
    calls = [
        ("wcsph_density", f.density, geom, {}),
        ("wcsph_stat", f.stat, boundary.geom, {}),
        ("wcsph_stat[fluid->fluid]", f.stat, geom, {}),
        ("wcsph_forces", f.forces, geom, dict(
            q_vals=(pres, dens, v), s_vals=(pres, dens, v), scalars=(dt,))),
    ]
    for label, form, src, kw in calls:
        rec.check_pair(
            "pair_reduce", label, form,
            lambda: pr.pair_reduce(form, geom, src, c, **kw),
            lambda: pr.pair_reduce_ref(form.term_fn, form.n_out, geom, src,
                                       c.radius_sq, **kw),
            carry.mask.expand(form.n_out, *carry.mask.shape))
    rec.require_nonzero([f"pair_reduce_{n}" for n in WCSPH_FORMS])
    adv = carry.pos + carry.v * dt
    rec.check_rebucket("rebucket", "wcsph advect",
                       lambda: rb.rebucket(adv, carry.mask, carry.v, solver.grid),
                       lambda: rb.rebucket_ref(adv, carry.mask, carry.v, solver.grid),
                       overflow=False)


def live_rows(state):
    alive = state.alive
    rows = torch.cat([state.positions, state.densities[:, None]], dim=1)[alive]
    rows = rows.cpu().numpy()
    return rows[np.lexsort(rows.T)]


def phase_small_reference(device):
    """Kernels on the GPU against the twins on the CPU, 5 steps of a 3k scene."""
    from yasph2d_tpu_torch.scenes import double_dam_break

    for kind in PATHS:
        runs = {}
        for dev in (device, torch.device("cpu")):
            solver, boundary = build_solver(kind, double_dam_break(3_000), dev)
            carry = solver.init_carry(double_dam_break(3_000).initial_state(device=dev),
                                      boundary)
            counts = []
            for _ in range(5):
                carry, d = solver.simulate(carry, boundary, 1)
                counts.append((d.density_iterations, d.divergence_iterations,
                               d.neighbor_drops))
            runs[dev.type] = (counts, live_rows(solver.export_state(carry)))
        (gc, grows), (cc, crows) = runs["cuda"], runs["cpu"]
        diff = float(np.abs(grows - crows).max()) if grows.shape == crows.shape else None
        log(f"phase 4 small reference: {kind} {grows.shape[0]} particles, "
            f"(iterations, drops) gpu {gc} cpu {cc}, max row diff {diff!r}")
        if gc != cc or grows.shape != crows.shape or not np.allclose(
                grows, crows, rtol=1e-5, atol=1e-5):
            raise RuntimeError(f"{kind}: GPU kernels and CPU twins disagree on the "
                               "small scene")


def reset_launch_counts():
    from yasph2d_tpu_torch.ops import pair_reduce, rebucket, sm_pair_reduce, sm_rebucket

    for mod in (pair_reduce, rebucket, sm_pair_reduce, sm_rebucket):
        mod.reset_launch_counts()


def launch_counts() -> dict:
    from yasph2d_tpu_torch.ops import pair_reduce, rebucket, sm_pair_reduce, sm_rebucket

    counts = {f"pair_reduce_{k}": v for k, v in pair_reduce.LAUNCHES.items()}
    counts.update({f"sm_pair_reduce_{k}": v for k, v in sm_pair_reduce.LAUNCHES.items()})
    counts.update(rebucket.LAUNCHES)
    counts.update(sm_rebucket.LAUNCHES)
    return counts


def phase_main_path(device, kind) -> dict:
    from yasph2d_tpu_torch.scenes import double_dam_break

    world = double_dam_break(100_000)
    assert world.num_dynamic_particles == N_FLUID, world.num_dynamic_particles
    solver, boundary = build_solver(kind, world, device)
    grid = solver.grid
    state = world.initial_state(device=device)
    torch.cuda.synchronize()

    reset_launch_counts()
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
    launches = launch_counts()

    s = solver.export_state(carry)
    live = int(s.alive.sum())
    rho0 = solver.properties.fluid_density
    pos, vel, dens = s.positions[s.alive], s.velocities[s.alive], s.densities[s.alive]
    finite = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()
                  and torch.isfinite(dens).all())
    dmin, dmax = float(dens.min()), float(dens.max())
    drops = max(d.neighbor_drops for d in diags)
    ms = elapsed / STEPS * 1e3
    log(f"phase 5 main path [{kind}]: grid {grid.nx}x{grid.ny} P {grid.occupancy}, "
        f"{live} live / {world.num_boundary_particles} boundary, init {t_init:.3f} s, "
        f"{STEPS} steps {ms:.3f} ms/step {live * STEPS / elapsed:.1f} particle-steps/s, "
        f"drops {drops}, density [{dmin!r}, {dmax!r}], dt {float(carry.time.dt)!r}, "
        f"max |v| {float(max(d.max_velocity for d in diags))!r}")
    if kind == "dfsph_plane":
        iters = [(d.density_iterations, d.divergence_iterations) for d in diags]
        log(f"phase 5 main path [{kind}]: iterations per step (density, divergence) "
            f"{iters}")
    path = {k: launches[k] for k in PATHS[kind]}
    log(f"phase 5 main path [{kind}]: launches {path}")
    problems = [k for k, v in path.items() if v <= 0]
    if problems:
        raise RuntimeError(f"{kind}: kernels never launched on the main path: {problems}")
    if drops != 0 or live != N_FLUID or not finite:
        raise RuntimeError(f"{kind}: main path state wrong: drops {drops} live {live} "
                           f"finite {finite}")
    if not (rho0 <= dmin and dmax <= 1.3 * rho0):
        raise RuntimeError(f"{kind}: densities outside [rho0, 1.3 rho0]: [{dmin}, {dmax}]")
    return path


def main():
    phase_environment()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    rec = Records()
    phase_kernels_dfsph(device, rec)
    phase_kernels_wcsph(device, rec)
    phase_small_reference(device)
    launches = {}
    for kind in PATHS:
        for name, count in phase_main_path(device, kind).items():
            launches[name] = launches.get(name, 0) + count
    records = list(rec.by_name.values())
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
