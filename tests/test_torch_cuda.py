"""CUDA kernels of the PyTorch port against their plain twins, on the GPU.

Marked `cuda`; each test skips when no CUDA device is present (as on a
CPU-only test host). Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels perform the twins' float32 operations in the same order (built
with -fmad=false), so pair outputs (K1, K3) are compared to rtol 1e-5 plus
1e-6 of the plane's scale and the re-buckets (K2, K4) bit for bit."""

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch import (
    AdaptiveTimeStep,
    DFSPHPlaneSolver,
    FluidParticleWorld,
    WCSPHPaddedSolver,
    WCSPHPlaneSolver,
    XSPHViscosityModel,
)
from yasph2d_tpu_torch.models.dfsph_plane import PlaneCtx
from yasph2d_tpu_torch.ops import pair_reduce as pr
from yasph2d_tpu_torch.ops import rebucket as rb
from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
from yasph2d_tpu_torch.ops import sm_rebucket as smr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig
from yasph2d_tpu_torch.ops.planes import PlaneGeom, to_planes
from yasph2d_tpu_torch.scenes import double_dam_break

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _planes(rng, shape, scale=1.0, offset=0.0):
    return torch.as_tensor((offset + scale * rng.random(shape)).astype(np.float32))


@pytest.fixture(scope="module")
def case(device):
    """Random fluid/boundary slot grids on a cell_size = h grid and pass inputs."""
    rng = np.random.default_rng(0)
    world = FluidParticleWorld(1.0, 60.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx, p, pb = 23, 37, 4, 2
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p)
    solver = DFSPHPlaneSolver(
        viscosity_model=XSPHViscosityModel(h), properties=world.properties,
        grid=grid, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5))

    def slots(pp, fill):
        mask = rng.random((ny, nx, pp)) < fill
        cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
        pos = cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h
        pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
        return to_planes(torch.as_tensor(pos)), to_planes(torch.as_tensor(mask))

    pos, mask = slots(p, 0.6)
    bpos, bmask = slots(pb, 0.3)
    shape = (p, ny, nx)
    ctx = PlaneCtx(pos=pos, mask=mask,
                   sum_grad_stat=_planes(rng, (2,) + shape, 40.0, -20.0),
                   neighbor_total=torch.floor(_planes(rng, shape, 18.0)),
                   densities=_planes(rng, shape, 5.0, 100.0),
                   alpha=_planes(rng, shape, 1e-3),
                   num_dropped=torch.zeros((), dtype=torch.int32))
    vals = dict(v=_planes(rng, (2,) + shape, 2.0, -1.0), k=_planes(rng, shape, 50.0, -25.0),
                rho=_planes(rng, shape, 30.0, 100.0))
    return solver, ctx, PlaneGeom(bpos, bmask), vals


def _operands(solver, ctx, bgeom, vals, form):
    f, g = solver._forms, ctx.geom
    v, k, rho, dt = vals["v"], vals["k"], vals["rho"], 1.0 / 2700.0
    return {
        "ctx": (f.ctx, bgeom, {}),
        "ctx_post": (f.ctx_post, g, dict(post_planes=(
            pr.pair_reduce_ref(f.ctx.term_fn, 5, g, bgeom, solver._consts.radius_sq),))),
        "visc_gravity": (f.visc_gravity, g, dict(q_vals=(v,), s_vals=(v, rho),
                                                 scalars=(dt,))),
        "err_ki": (f.err_ki, g, dict(q_vals=(v,), s_vals=(v,), scalars=(dt,), post_planes=(
            v, ctx.sum_grad_stat, ctx.densities, ctx.alpha))),
        "delta_ki": (f.delta_ki, g, dict(q_vals=(v,), s_vals=(v,), post_planes=(
            v, ctx.sum_grad_stat, ctx.neighbor_total, ctx.alpha))),
        "corr_v": (f.corr_v, g, dict(q_vals=(k,), s_vals=(k,), scalars=(1234.5,),
                                     post_planes=(v, k, ctx.sum_grad_stat))),
    }[form]


def _to(device, kw):
    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, tuple):
            return tuple(move(y) for y in x)
        return x
    return {key: move(val) for key, val in kw.items()}


@pytest.mark.parametrize("form", ["ctx", "ctx_post", "visc_gravity", "err_ki",
                                  "delta_ki", "corr_v"])
def test_pair_kernel_matches_twin(device, case, form):
    solver, ctx, bgeom, vals = case
    pform, src, kw = _operands(solver, ctx, bgeom, vals, form)
    q = PlaneGeom(ctx.pos.to(device), ctx.mask.to(device))
    s = PlaneGeom(src.pos.to(device), src.mask.to(device))
    kw = _to(device, kw)
    before = pr.LAUNCHES[pform.name]
    out = pr.pair_reduce(pform, q, s, solver._consts, **kw)
    assert pr.LAUNCHES[pform.name] == before + 1
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, s, solver._consts.radius_sq,
                             post_fn=pform.post_fn, n_acc=pform.n_acc, **kw)
    torch.cuda.synchronize()
    live = q.mask.expand_as(out)
    a, b = out[live], ref[live]
    scale = max(1.0, float(b.abs().max()))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * scale)
    assert (out[~live] == 0).all()
    assert float(b.abs().sum()) > 0


@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_rebucket_kernel_bit_equal(device, case, shift):
    solver, ctx, _, vals = case
    h = solver.grid.cell_size
    pos = ctx.pos.clone()
    pos[0] += shift * h  # a shift of 0.6 cells crowds cells: forced overflow
    pos = (pos + (torch.rand(pos.shape, generator=torch.Generator().manual_seed(1))
                  - 0.5) * 0.2 * h).to(device)
    mask = ctx.mask.to(device)
    extra = torch.cat([vals["v"], vals["k"][None], vals["rho"][None]]).to(device)
    out = rb.rebucket(pos, mask, extra, solver.grid)
    ref = rb.rebucket_ref(pos, mask, extra, solver.grid)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    if shift:
        assert int(out[3]) > 0


@pytest.fixture(scope="module")
def wcase(device):
    """Random fluid/boundary slot grids in the slot-major layout, seeded
    pressure, density and velocity, and the two WCSPH solvers."""
    rng = np.random.default_rng(1)
    world = FluidParticleWorld(2.0, 400.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx, p, pb = 23, 37, 5, 3
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p)
    common = dict(viscosity_model=XSPHViscosityModel(h), properties=world.properties,
                  grid=grid, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 0.2))

    def slots(pp, fill):
        mask = rng.random((ny, nx, pp)) < fill
        cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
        pos = cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h
        pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
        return torch.as_tensor(pos).to(device), torch.as_tensor(mask).to(device)

    fluid, walls = slots(p, 0.6), slots(pb, 0.4)
    vals = tuple(_planes(rng, (ny, nx, p) + tail, scale, offset).to(device)
                 for tail, scale, offset in (((), 500.0, 0.0), ((), 30.0, 100.0),
                                             ((2,), 2.0, -1.0)))
    return WCSPHPaddedSolver(**common), WCSPHPlaneSolver(**common), fluid, walls, vals


@pytest.mark.parametrize("form,boundary", [
    ("density", False), ("stat", True), ("stat", False), ("forces", False)])
def test_sm_pair_kernel_matches_twin(device, wcase, form, boundary):
    padded, _, (pos, mask), walls, vals = wcase
    pform = getattr(padded._forms, form)
    s_pos, s_mask = walls if boundary else (pos, mask)
    kw = dict(q_vals=vals, s_vals=vals, scalars=(1.0 / 2700.0,)) if form == "forces" else {}
    before = smp.LAUNCHES[pform.name]
    out = smp.sm_pair_reduce(pform, pos, mask, s_pos, s_mask, padded._consts, **kw)
    assert smp.LAUNCHES[pform.name] == before + 1
    ref = smp.sm_pair_reduce_ref(pform.term_fn, pform.n_out, pos, mask, s_pos, s_mask,
                                 padded._consts.radius_sq, **kw)
    torch.cuda.synchronize()
    live = mask[..., None].expand_as(out)
    a, b = out[live], ref[live]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * max(1.0, float(b.abs().max())))
    assert (out[~live] == 0).all()
    assert float(b.abs().sum()) > 0


@pytest.mark.parametrize("form", ["density", "stat", "forces"])
def test_pair_kernel_wcsph_forms_match_twin(device, wcase, form):
    _, plane, (pos, mask), walls, (pres, rho, v) = wcase
    pform = getattr(plane._forms, form)
    q = PlaneGeom(to_planes(pos), to_planes(mask))
    s = PlaneGeom(to_planes(walls[0]), to_planes(walls[1])) if form == "stat" else q
    pv = (to_planes(pres), to_planes(rho), to_planes(v))
    kw = dict(q_vals=pv, s_vals=pv, scalars=(1.0 / 2700.0,)) if form == "forces" else {}
    out = pr.pair_reduce(pform, q, s, plane._consts, **kw)
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, s, plane._consts.radius_sq,
                             **kw)
    torch.cuda.synchronize()
    live = q.mask.expand_as(out)
    a, b = out[live], ref[live]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * max(1.0, float(b.abs().max())))
    assert float(b.abs().sum()) > 0


@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_sm_rebucket_kernel_bit_equal(device, wcase, shift):
    padded, _, (pos, mask), _, (pres, rho, v) = wcase
    h = padded.grid.cell_size
    adv = pos.clone()
    adv[..., 0] += shift * h  # a shift of 0.6 cells crowds cells: forced overflow
    noise = torch.rand(adv.shape, generator=torch.Generator().manual_seed(2)) - 0.5
    adv = adv + noise.to(device) * 0.2 * h
    values = torch.cat([v, rho[..., None]], dim=-1)
    out = smr.sm_rebucket(adv, mask, values, padded.grid)
    ref = smr.sm_rebucket_ref(adv, mask, values, padded.grid)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        assert torch.equal(a, b)
    if shift:
        assert int(out[3]) > 0


@pytest.mark.parametrize("kind", ["wcsph_padded", "wcsph_plane"])
def test_wcsph_solver_gpu_matches_cpu(device, kind):
    """Five adaptive steps of a 3k double dam-break: kernels on the GPU, twins
    on the CPU; equal drops and live rows."""
    rows, drops = {}, {}
    cls = WCSPHPaddedSolver if kind == "wcsph_padded" else WCSPHPlaneSolver
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        grid = world.dense_grid(occupancy=7)
        solver = cls(
            viscosity_model=XSPHViscosityModel(world.properties.smoothing_length),
            properties=world.properties, grid=grid,
            step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 0.2))
        boundary = world.boundary_dense(grid, device=dev)
        if kind == "wcsph_plane":
            boundary = solver.boundary_planes(boundary)
        carry = solver.init_carry(world.initial_state(device=dev), boundary)
        drops[dev.type] = []
        for _ in range(5):
            carry, diag = solver.simulate(carry, boundary, 1)
            drops[dev.type].append(diag.neighbor_drops)
        s = solver.export_state(carry)
        r = torch.cat([s.positions, s.densities[:, None]], 1)[s.alive].cpu().numpy()
        rows[dev.type] = r[np.lexsort(r.T)]
    assert drops["cuda"] == drops["cpu"]
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-5, atol=1e-5)


def test_solver_gpu_matches_cpu(device):
    """Five adaptive steps of a 3k double dam-break: kernels on the GPU, twins
    on the CPU; equal iteration counts and live rows."""
    rows, iters = {}, {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        grid = world.dense_grid(occupancy=7)
        solver = DFSPHPlaneSolver(
            viscosity_model=XSPHViscosityModel(world.properties.smoothing_length),
            properties=world.properties, grid=grid,
            step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5))
        boundary = solver.boundary_planes(world.boundary_dense(grid, device=dev))
        carry = solver.init_carry(world.initial_state(device=dev), boundary)
        it = []
        for _ in range(5):
            carry, d = solver.simulate(carry, boundary, 1)
            it.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
        s = solver.export_state(carry)
        r = torch.cat([s.positions, s.densities[:, None]], 1)[s.alive].cpu().numpy()
        rows[dev.type], iters[dev.type] = r[np.lexsort(r.T)], it
    assert iters["cuda"] == iters["cpu"]
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-5, atol=1e-5)
