"""ops/pressure_glue.py on the CPU: its twins are the DFSPH pressure loops'
glue as the loops wrote it in torch operations, bit for bit, on the K3, K5,
K5 bf16 and sorted routes, through an impact whose loops iterate and warm
start; its wrappers refuse an operand their kernels do not take; and a CPU
run, the plane step's unfused loops and the loop-gradient variants launch
nothing. The loops' exit test on the device: the host loops' test bit for
bit, the same carries and diagnostics as the host's test on every route, however far
the chunks over- or undershoot (the loop launchers on CPU tensors run the
twins gated); the routes that keep the host's test read back once an
iteration. The kernels against the twins on the card:
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.models.dfsph_dense import DFSPHSlotSolver
from yasph2d_tpu_torch.ops import pressure_glue as pg
from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
from yasph2d_tpu_torch.utils import profiling

f32 = np.float32
CPU = torch.device("cpu")
# the benchmark's dfsph_converged_f32 knobs: the density loop iterates
# (3-17 times a step at ~1000 particles from the impact on, step 27)
TOLERANCE, CFL = 1e-8, 0.75
SETTLE, STEPS = 26, 5


def _inline_density_loop(self, dt, dens_pad, alpha_pad, v_pad, kappa_pad,
                         prev_iterations, ctx, n_particles):
    """The constant-density loop as it was written before
    ops/pressure_glue.py."""
    rho0 = f32(self.properties.fluid_density)
    m = f32(self.properties.particle_mass)
    scale = float((f32(1.0) / f32(dt)) * m)
    tol = f32(self.max_avg_density_error)
    if prev_iterations > 1:
        k = 0.5 * torch.clamp(kappa_pad, min=float(f32(-0.5) * rho0 * rho0))
        v_pad = v_pad - scale * self._k_correction(ctx, k)
    k_sum = torch.zeros_like(kappa_pad)
    num, avg = 0, f32(np.inf)
    while num == 0 or ((avg / rho0) * dt >= tol and num <= self.max_density_iterations):
        delta = self._velocity_divergence(ctx, v_pad)
        err = torch.clamp(dens_pad + delta * float(m) * float(dt),
                          min=float(rho0)) - float(rho0)
        ki = err * alpha_pad
        k_sum = k_sum + ki
        v_pad = v_pad - scale * self._k_correction(ctx, ki)
        avg = self._mean_of_sum(torch.where(ctx.mask, err, 0.0).sum(), n_particles)
        num += 1
    return v_pad, k_sum, num, avg


def _inline_divergence_loop(self, dt, alpha_pad, v_pad, stiff_pad, prev_iterations, ctx,
                            n_particles):
    """The divergence-free loop as it was written before
    ops/pressure_glue.py."""
    rho0 = f32(self.properties.fluid_density)
    m = float(f32(self.properties.particle_mass))
    tol = f32(self.max_divergence_error)
    if prev_iterations > 1:
        s = 0.5 * torch.clamp(stiff_pad, min=float(f32(-0.5) * rho0 * rho0))
        v_pad = v_pad - m * self._k_correction(ctx, s)
    s_sum = torch.zeros_like(stiff_pad)
    num, avg = 0, f32(np.inf)
    while num == 0 or (avg * dt >= tol and num <= self.max_divergence_iterations):
        delta = torch.clamp(self._velocity_divergence(ctx, v_pad) * m, min=0.0)
        delta = torch.where(ctx.neighbor_total < 9, 0.0, delta)
        ki = delta * alpha_pad
        s_sum = s_sum + ki
        v_pad = v_pad - m * self._k_correction(ctx, ki)
        avg = self._mean_of_sum(torch.where(ctx.mask, delta, 0.0).sum(), n_particles) / rho0
        num += 1
    return v_pad, s_sum, num, avg


def converged_solver(kind, particles=1000, device=CPU):
    """(solver, boundary, carry at rest) of a SOLVERS kind on the small
    double dam-break with the converged knobs."""
    world = double_dam_break(particles)
    solver, boundary = bench_solver(kind, world, device=device)
    solver = dataclasses.replace(
        solver, max_avg_density_error=TOLERANCE,
        step_config=dataclasses.replace(solver.step_config, cfl_factor=CFL))
    return solver, boundary, solver.init_carry(world.initial_state(device=device), boundary)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def carry_tensors(tree) -> list:
    """Every tensor of a carry (nested named tuples)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for item in tree for t in carry_tensors(item)]
    return []


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "dfsph_padded", "dfsph_padded_k5_bf16",
                                  "dfsph_dense_k5"])
def test_loops_equal_their_inline_glue_bit_for_bit(kind, monkeypatch):
    """Five steps through the impact, loops iterating and warm starting:
    the loops through the twins give the inline glue's carries (every
    tensor, every slot's bits, dead ones too), iterations, dt and residual
    averages."""
    solver, boundary, carry = converged_solver(kind)
    carry, _ = solver.simulate(carry, boundary, SETTLE)
    runs = []
    for inline in (False, True):
        if inline:
            monkeypatch.setattr(DFSPHSlotSolver, "_correct_density_error",
                                _inline_density_loop)
            monkeypatch.setattr(DFSPHSlotSolver, "_correct_divergence_error",
                                _inline_divergence_loop)
        c, out = carry, []
        for _ in range(STEPS):
            c, d = solver.simulate(c, boundary, 1)
            out.append((d.density_iterations, d.divergence_iterations, f32(d.dt).tobytes(),
                        f32(d.avg_density_error).tobytes(), f32(d.avg_divergence).tobytes()))
        runs.append((c, out))
    (got, got_d), (ref, ref_d) = runs
    assert got_d == ref_d
    assert max(d[0] for d in got_d) > 2 and min(d[1] for d in got_d) >= 1
    a, b = carry_tensors(got), carry_tensors(ref)
    assert len(a) == len(b) > 5
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(_bits(x), _bits(y))


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "dfsph_dense_k5", "dfsph_plane_unfused",
                                  "dfsph_padded_cached", "dfsph_dense_mxu"])
def test_cpu_runs_launch_nothing(kind):
    """A CPU run launches no glue kernel, on the slot routes (the twins),
    the plane step's unfused loops and the loop-gradient variants (their
    torch glue)."""
    world = double_dam_break(1000)
    solver, boundary = bench_solver(kind, world, device=CPU)
    carry = solver.init_carry(world.initial_state(device=CPU), boundary)
    before = dict(pg.LAUNCHES)
    solver.simulate(carry, boundary, 2)
    assert pg.LAUNCHES == before


def _operands(ny=3, nx=4, p=2):
    g = torch.Generator().manual_seed(0)
    mask = torch.rand((ny, nx, p), generator=g) < 0.5
    scalar = torch.rand((ny, nx, p), generator=g)
    vec = torch.rand((ny, nx, p, 2), generator=g)
    calls = dict(
        slot_pressure_err=lambda m, s, v: pg.slot_pressure_err(
            s, v, v, s, s, s, None, m, 0.01, 1e-3, 100.0, True, True),
        slot_pressure_kick=lambda m, s, v: pg.slot_pressure_kick(v, v, s, v, m, 2.0, True))
    return calls, mask, scalar, vec


@pytest.mark.parametrize("fault", ["float64", "planes", "slots", "mask_dtype"])
@pytest.mark.parametrize("name", list(pg.LAUNCHES))
def test_wrappers_refuse_other_operands(name, fault):
    """Each wrapper runs on the slot-major operands and refuses a float64
    operand, the plane layout (C, P, ny, nx), another slot count, and a
    mask that is not bool."""
    calls, mask, scalar, vec = _operands()
    calls[name](mask, scalar, vec)
    if fault == "float64":
        scalar, vec = scalar.double(), vec.double()
    elif fault == "planes":
        scalar, vec = scalar.permute(2, 0, 1), vec.permute(3, 2, 0, 1)
    elif fault == "slots":
        scalar, vec = scalar[..., :1], vec[..., :1, :]
    else:
        mask = mask.to(torch.uint8)
    with pytest.raises(ValueError, match=name):
        calls[name](mask, scalar, vec)


@pytest.mark.parametrize("density", [True, False])
def test_twin_is_loop_error_of_the_divergence(density):
    """pressure_err_ref is loop_error of div + v . sgs, whose total is the
    where-sum over live slots; a NaN at a live slot reaches the total, at a
    dead one it does not."""
    rng = np.random.default_rng(1)
    shape = (5, 6, 3)
    t = lambda *s, lo=-1.0, hi=1.0: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, shape + s).astype(np.float32))
    mask = torch.as_tensor(rng.random(shape) < 0.5)
    div, v, sgs, alpha, k_sum = t(), t(2), t(2), t(lo=0.0), t()
    rho = t(lo=99.0, hi=101.0) if density else torch.floor(t(lo=0.0, hi=18.0))
    args = (100.0 * 0.0025, 1e-3, 100.0, density)
    ki, ks, total = pg.pressure_err_ref(div, v, sgs, rho, alpha, k_sum, None, mask, *args)
    delta = div + (v[..., 0] * sgs[..., 0] + v[..., 1] * sgs[..., 1])
    ref = pg.loop_error(delta, rho, alpha, k_sum, mask, *args[:3], density)
    for a, b in zip((ki, ks, total), ref):
        assert torch.equal(_bits(a), _bits(b))
    assert bool(ki.ne(0).any())
    if not density:  # no deficiency guard, which would zero the NaN
        rho = torch.full_like(rho, 12.0)
    for live in (False, True):
        where = tuple(int(i[0]) for i in torch.nonzero(mask == live)[:1].T)
        bad = div.clone()
        bad[where] = float("nan")
        total = pg.pressure_err_ref(bad, v, sgs, rho, alpha, k_sum, None, mask, *args)[2]
        assert bool(torch.isnan(total)) == live


# ------------------------------------------------- the exit test on the device


def _device_route(monkeypatch):
    """Run the pressure loops' device route (the exit test on the device,
    iterations enqueued ahead and gated) on CPU tensors, through the twins:
    `_device_exit` holds wherever the glue is ops/pressure_glue.py's and the
    sums are local, whatever the device."""
    monkeypatch.setattr(DFSPHSlotSolver, "_device_exit",
                        lambda self, ctx: self._slot_glue(ctx) and self._local_sums())


def _diagnostics(d):
    return (d.density_iterations, d.divergence_iterations, f32(d.dt).tobytes(),
            f32(d.avg_density_error).tobytes(), f32(d.avg_divergence).tobytes())


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "dfsph_padded", "dfsph_padded_k5_bf16",
                                  "dfsph_dense_k5"])
def test_device_exit_route_equals_the_host_test(kind, monkeypatch):
    """Through the impact, the device route (its loop launchers on CPU
    tensors run the twins gated and test as the kernels do) gives the host
    test's dt, iterations,
    residual averages and carries bit for bit: from the carried counts, and
    from previous counts that undershoot (1: one chunk is not enough) and
    overshoot (60: most enqueued iterations are gated off). The counters
    say so: the host test reads back once an iteration and enqueues what it
    runs; the device route reads its state back once a chunk."""
    solver, boundary, carry = converged_solver(kind)
    carry, _ = solver.simulate(carry, boundary, SETTLE)
    starts = [carry, carry._replace(prev_density_iterations=1, prev_divergence_iterations=1),
              carry._replace(prev_density_iterations=60, prev_divergence_iterations=60)]
    runs = []
    for device_exit in (False, True):
        if device_exit:
            _device_route(monkeypatch)
        pg.reset_launch_counts()
        profiling.reset_readbacks()
        out = []
        for c in starts:
            for _ in range(3):
                c, d = solver.simulate(c, boundary, 1)
                out.append(_diagnostics(d))
            out.append(c)
        runs.append((out, dict(pg.ITERATIONS), dict(profiling.READBACKS)))
    (host, host_its, host_reads), (dev, dev_its, dev_reads) = runs
    for a, b in zip(host, dev):
        if isinstance(a, tuple) and isinstance(a[0], int):
            assert a == b
        else:
            x, y = carry_tensors(a), carry_tensors(b)
            assert len(x) == len(y) > 5
            assert all(torch.equal(_bits(p), _bits(q)) for p, q in zip(x, y))
    runs_total = sum(d[0] + d[1] for d in host if isinstance(d, tuple) and isinstance(d[0], int))
    assert max(d[0] for d in host if isinstance(d, tuple) and isinstance(d[0], int)) > 2
    assert host_its["density_run"] + host_its["divergence_run"] == runs_total
    assert host_its == {**dev_its, "density_enqueued": host_its["density_run"],
                        "divergence_enqueued": host_its["divergence_run"]}
    assert host_reads["mean_residual"] == runs_total and "loop_state" not in host_reads
    assert "mean_residual" not in dev_reads and dev_reads["loop_state"] >= 18
    assert dev_its["density_enqueued"] > dev_its["density_run"] + 40  # the overshooting start


def test_exit_test_is_the_host_loops_test():
    """`exit_test` is the loops' test as they wrote it, in float32: the
    density loop goes on while (mean / rho0) dt >= tol and reports the
    mean, the divergence loop while (mean / rho0) dt >= tol and reports
    mean / rho0; at, just above and just below the tolerance."""
    rho0, dt = f32(100.0), f32(1.3e-4)
    for mean in (f32(7.7e-3), f32(0.31), f32(np.inf), f32(np.nan)):
        x = (mean / rho0) * dt
        for tol in (x, np.nextafter(x, f32(np.inf)), np.nextafter(x, f32(-np.inf)),
                    f32(1e-8)):
            avg, goes_on = pg.exit_test(mean, rho0, dt, tol, density=True)
            assert avg.tobytes() == mean.tobytes() and goes_on == bool(x >= tol)
            avg, goes_on = pg.exit_test(mean, rho0, dt, tol, density=False)
            ratio = mean / rho0
            assert avg.tobytes() == ratio.tobytes() and goes_on == bool(ratio * dt >= tol)


def _err_operands(density):
    """A small slot grid's error operands (slot_pressure_err's order, no
    work), with a positive total."""
    rng = np.random.default_rng(3)
    shape = (6, 5, 4)
    t = lambda *s, lo=-1.0, hi=1.0: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, shape + s).astype(np.float32))
    mask = torch.as_tensor(rng.random(shape) < 0.6)
    rho = t(lo=99.0, hi=101.0) if density else torch.full(shape, 12.0)
    return (t(), t(2), t(2), rho, t(lo=0.0), t(), None, mask, 0.25, 1.3e-4, 100.0, density)


@pytest.mark.parametrize("density", [True, False], ids=["density", "divergence"])
def test_loop_launchers_on_the_cpu_test_and_write_nothing(density):
    """The loop launchers on CPU tensors (the twins, in place): the error's
    launch of iteration i writes the twin's k_i and k_sum and sets the
    state to go on exactly where the host test would (at, just above and
    just below the tolerance), reports the host's average and stops at the
    cap; a launch of an iteration past the loop's last writes nothing (the
    error's, the kick's, K5's and K3's)."""
    div, v, sgs, rho, alpha, k_sum, _, mask, m, dt, rho0, _ = ops = _err_operands(density)
    ref = pg.pressure_err_ref(*ops)
    n_live = f32(17.0)
    mean = f32(ref[2].item()) / n_live
    x = (mean / f32(rho0)) * f32(dt)
    decided = set()
    for tol in (x, np.nextafter(x, f32(np.inf)), np.nextafter(x, f32(-np.inf))):
        for i, cap in ((0, 200), (4, 5), (5, 5)):
            ki, sums, state = torch.zeros_like(k_sum), k_sum.clone(), torch.tensor([i, 0])
            state = state.to(torch.int32)
            pg.err_launcher(div, v, sgs, rho, alpha, sums, None, mask, m, dt, rho0, density,
                            True, (ki, state), pg.ExitTest(float(n_live), float(tol), cap))(i)
            assert torch.equal(_bits(ki), _bits(ref[0])) and torch.equal(_bits(sums),
                                                                        _bits(ref[1]))
            avg, goes_on = pg.exit_test(mean, rho0, dt, tol, density)
            on = goes_on and i + 1 <= cap
            decided.add(on)
            assert state.tolist()[0] == (i + 1 if on else i)
            assert np.int32(state.tolist()[1]).view(f32).tobytes() == avg.tobytes()
    assert decided == {True, False}
    state = torch.tensor([2, 7], dtype=torch.int32)
    ki, sums, w = torch.zeros_like(k_sum), k_sum.clone(), v.clone()
    pg.err_launcher(div, v, sgs, rho, alpha, sums, None, mask, m, dt, rho0, density, True,
                    (ki, state), pg.ExitTest(17.0, 0.0, 200))(3)
    pg.kick_launcher(w, v, k_sum, sgs, mask, 2.0, True, state)(3)
    assert not bool(ki.ne(0).any()) and torch.equal(sums, k_sum) and torch.equal(w, v)
    assert state.tolist() == [2, 7]
    pg.kick_launcher(w, v, k_sum, sgs, mask, 2.0, True, state)(2)
    assert torch.equal(w, pg.pressure_kick_ref(v, v, k_sum, sgs, mask, 2.0))
    for kind in ("dfsph_padded_k5", "dfsph_padded"):
        solver, _, carry = converged_solver(kind)
        ctx, f = carry.ctx, solver._forms
        vel = torch.rand(carry.v_pad.shape, generator=torch.Generator().manual_seed(0))
        out = torch.full(ctx.mask.shape + (1,), 7.0)
        launch = solver._route.loop_launcher(f.div, ctx.pos_pad, ctx.mask, ctx.pos_pad,
                                             ctx.mask, solver._consts, (vel,), (vel,), out,
                                             state)
        launch(3)
        assert bool((out == 7.0).all())
        launch(2)
        assert torch.equal(out[..., 0], solver._div_pass(ctx, vel)) and bool(out.ne(0).any())


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "dfsph_padded", "dfsph_dense_k5",
                                  "dfsph_plane", "dfsph_plane_unfused", "dfsph_padded_cached",
                                  "dfsph_dense_mxu"])
def test_host_test_routes_read_back_every_iteration(kind):
    """CPU runs, the plane steps and the loop-gradient variants keep the
    host's exit test: one "mean_residual" read-back an iteration, no loop
    state read, every enqueued iteration run."""
    world = double_dam_break(1000)
    solver, boundary = bench_solver(kind, world, device=CPU)
    carry = solver.init_carry(world.initial_state(device=CPU), boundary)
    pg.reset_launch_counts()
    profiling.reset_readbacks()
    carry, d = solver.simulate(carry, boundary, 2)
    runs = d.density_iterations + d.divergence_iterations
    assert profiling.READBACKS["mean_residual"] == runs and "loop_state" not in profiling.READBACKS
    assert pg.ITERATIONS["density_enqueued"] == pg.ITERATIONS["density_run"] > 0
    assert pg.ITERATIONS["divergence_enqueued"] == pg.ITERATIONS["divergence_run"] > 0
    assert pg.ITERATIONS["density_run"] + pg.ITERATIONS["divergence_run"] == runs
