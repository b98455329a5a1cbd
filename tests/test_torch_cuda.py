"""CUDA kernels of the PyTorch port against their plain twins, on the GPU.

Marked `cuda`; each test skips when no CUDA device is present (as on a
CPU-only test host). Imports no JAX, so it runs on a GPU host without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The kernels perform the twins' float32 operations in the same order (built
with -fmad=false; K5's twin sums each view's candidates with torch.sum), so
K1 in both operand modes, K3, K7 and the re-buckets (K2, K4) are compared bit
for bit, K5 to rtol 1e-5 plus 1e-6 of the plane's scale. The physical
viscosity forms (PhysicalViscosityModel, mu = 0.01) are held as the XSPH
ones, also on sources whose dead slots hold rho = 0 or NaN. The FMA probe of K6 rounds once per step where its twin rounds twice
(rtol 1e-5); its mix probe is bit-equal to the twin. The halo forms of K1 and
K2 (spatial sharding) are bit-equal to their twins and, band by band, to the
one-device kernels on the whole grid; the sharded plane steps on two gloo
ranks sharing the card equal the one-device step. So do the halo forms of K5
(to its twin at K5's tolerance, to the one-device kernel's rows bit for bit)
and K4 (bit for bit), and the sharded padded K5 steps. The table solvers
(plain tensor operations) and the sorted solvers (K3 or K5, no K4) on the
card agree with themselves on the CPU, and keep every tensor on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch import (
    AdaptiveTimeStep,
    DFSPHPaddedSolver,
    DFSPHPlaneSolver,
    FluidParticleWorld,
    PhysicalViscosityModel,
    WCSPHPaddedSolver,
    WCSPHPlaneSolver,
    XSPHViscosityModel,
)
from yasph2d_tpu_torch.models.dfsph_plane import PlaneCtx
from yasph2d_tpu_torch.ops import pair_reduce as pr
from yasph2d_tpu_torch.ops import pallas_pair as tpp
from yasph2d_tpu_torch.ops import rebucket as rb
from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
from yasph2d_tpu_torch.ops import sm_rebucket as smr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig
from yasph2d_tpu_torch.ops.planes import Halo, PlaneGeom, plane_geom, to_planes
from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc
from yasph2d_tpu_torch.tools import tile_sweep
from yasph2d_tpu_torch.tools import vpu_probe as vp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _physical(solver):
    """`solver` with the reference's high-viscosity model (physical, mu =
    0.01, main.rs:95-96): its viscosity forms are the *_phys launchers."""
    h = solver.properties.smoothing_length
    return dataclasses.replace(
        solver, viscosity_model=PhysicalViscosityModel(h, fluid_viscosity=0.01))


def _planes(rng, shape, scale=1.0, offset=0.0):
    return torch.as_tensor((offset + scale * rng.random(shape)).astype(np.float32))


@pytest.fixture(scope="module")
def case(device):
    """Random fluid/boundary slot grids on a cell_size = h grid and pass inputs."""
    rng = np.random.default_rng(0)
    world = FluidParticleWorld(1.0, 60.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx, p, pb = 23, 37, 4, 2
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p,
                           use_pallas_slotmajor=True)
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
                   num_dropped=torch.zeros((), dtype=torch.int32),
                   geom=PlaneGeom(pos, mask))
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
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (out[~q.mask.expand_as(out)] == 0).all()
    assert float(ref.abs().sum()) > 0


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
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p,
                           use_pallas_slotmajor=True)
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
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert float(ref.abs().sum()) > 0


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


@pytest.mark.parametrize("kind", ["wcsph_padded", "wcsph_plane", "wcsph_padded_k5",
                                  "wcsph_plane_bf16", "wcsph_padded_k5_bf16", "wcsph_table",
                                  "wcsph_dense", "wcsph_dense_k5"])
def test_wcsph_solver_gpu_matches_cpu(device, kind):
    """Five adaptive steps of a 3k double dam-break: kernels on the GPU, twins
    on the CPU; equal drops and live rows."""
    rows, drops = {}, {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        solver, boundary = bench_solver(kind, world, device=dev)
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


@pytest.mark.parametrize("kind", ["dfsph_plane", "dfsph_padded", "dfsph_padded_k5",
                                  "dfsph_plane_bf16", "dfsph_plane_unfused",
                                  "dfsph_padded_k5_bf16", "dfsph_table", "dfsph_dense",
                                  "dfsph_dense_k5", "dfsph_dense_k5_bf16"])
def test_solver_gpu_matches_cpu(device, kind):
    """Five adaptive steps of a 3k double dam-break: kernels on the GPU, twins
    on the CPU; equal iteration counts and live rows."""
    rows, iters = {}, {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        solver, boundary = bench_solver(kind, world, device=dev)
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


@pytest.mark.parametrize("kind", ["dfsph_dense", "dfsph_dense_k5", "dfsph_dense_k5_bf16",
                                  "wcsph_dense", "wcsph_dense_k5", "dfsph_table",
                                  "wcsph_table"])
def test_table_and_sorted_steps_stay_on_the_card(device, kind):
    """Three steps of a 3k double dam-break: the sorted kinds launch their
    pair kernel (K3, or K5 on `*_k5`) and never K4, the table kinds no
    kernel; every tensor of the carry is on the card."""
    world = double_dam_break(3_000)
    solver, boundary = bench_solver(kind, world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    for mod in (smp, tpp, smr):
        mod.reset_launch_counts()
    carry, diag = solver.simulate(carry, boundary, 3)
    torch.cuda.synchronize()
    pair = sum((tpp if kind.endswith(("_k5", "_k5_bf16")) else smp).LAUNCHES.values())
    assert (pair > 0) == ("dense" in kind) and sum(smr.LAUNCHES.values()) == 0
    tensors = []

    def collect(tree):
        if isinstance(tree, torch.Tensor):
            tensors.append(tree)
        elif isinstance(tree, tuple):
            for t in tree:
                collect(t)
    collect(carry)
    assert tensors and all(t.device.type == "cuda" for t in tensors)
    assert diag.neighbor_drops == 0


@pytest.fixture(scope="module")
def dcase(device):
    """Random fluid/boundary slot grids in the slot-major layout, seeded
    velocity, stiffness and density (dead slots hold rho = 0), and the DFSPH
    padded solver on each route."""
    rng = np.random.default_rng(3)
    world = FluidParticleWorld(2.0, 400.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx, p, pb = 23, 37, 6, 3
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p)
    common = dict(viscosity_model=XSPHViscosityModel(h), properties=world.properties,
                  step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5))
    solvers = {route: DFSPHPaddedSolver(**common, grid=dataclasses.replace(
        grid, use_pallas_slotmajor=sm)) for route, sm in (("k3", True), ("k5", False))}

    def slots(pp, fill):
        mask = rng.random((ny, nx, pp)) < fill
        cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
        pos = cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h
        pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
        return torch.as_tensor(pos).to(device), torch.as_tensor(mask).to(device)

    fluid, walls = slots(p, 0.6), slots(pb, 0.4)
    v = _planes(rng, (ny, nx, p, 2), 2.0, -1.0).to(device)
    k = _planes(rng, (ny, nx, p), 50.0, -25.0).to(device)
    rho = torch.where(fluid[1], _planes(rng, (ny, nx, p), 30.0, 100.0).to(device), 0.0)
    return solvers, fluid, walls, dict(v=v, k=k, rho=rho)


def _slot_operands(dcase, form, route):
    solvers, fluid, walls, vals = dcase
    v, k, rho = vals["v"], vals["k"], vals["rho"]
    f = solvers[route]._padded_forms
    return {
        "ctx": (f.ctx, fluid, {}),
        "stat": (f.stat, walls, {}),
        "div": (f.div, fluid, dict(q_vals=(v,), s_vals=(v,))),
        "corr": (f.corr, fluid, dict(q_vals=(k,), s_vals=(k,))),
        "visc": (f.visc, fluid, dict(q_vals=(v,), s_vals=(v, rho), scalars=(1.0 / 2700.0,))),
    }[form]


def _check_slot_kernel(mod, run, ref, pform, pos, mask, src, consts, kw):
    before = mod.LAUNCHES[pform.name]
    out = run(pform, pos, mask, src[0], src[1], consts, **kw)
    assert mod.LAUNCHES[pform.name] == before + 1
    twin = ref(pform.term_fn, pform.n_out, pos, mask, src[0], src[1], consts.radius_sq, **kw)
    torch.cuda.synchronize()
    live = mask[..., None].expand_as(out)
    a, b = out[live], twin[live]
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * max(1.0, float(b.abs().max())))
    assert (out[~live] == 0).all()
    assert float(b.abs().sum()) > 0


@pytest.mark.parametrize("form", ["ctx", "stat", "div", "corr", "visc"])
def test_sm_pair_kernel_dfsph_forms_match_twin(device, dcase, form):
    solvers, (pos, mask), _, _ = dcase
    pform, src, kw = _slot_operands(dcase, form, "k3")
    _check_slot_kernel(smp, smp.sm_pair_reduce, smp.sm_pair_reduce_ref, pform, pos, mask,
                       src, solvers["k3"]._consts, kw)


@pytest.mark.parametrize("form", ["ctx", "stat", "div", "corr", "visc"])
def test_tile_pair_kernel_dfsph_forms_match_twin(device, dcase, form):
    """K5's DFSPH forms; `stat` is its dfsph_ctx form against the boundary
    space (Ps != P)."""
    solvers, (pos, mask), _, _ = dcase
    pform, src, kw = _slot_operands(dcase, form, "k5")
    _check_slot_kernel(tpp, tpp.pallas_pair_reduce, tpp.pallas_pair_reduce_ref, pform,
                       pos, mask, src, solvers["k5"]._consts, kw)


@pytest.mark.parametrize("form,boundary", [
    ("density", False), ("stat", True), ("stat", False), ("forces", False)])
def test_tile_pair_kernel_wcsph_forms_match_twin(device, wcase, form, boundary):
    padded, _, (pos, mask), walls, vals = wcase
    k5 = WCSPHPaddedSolver(viscosity_model=padded.viscosity_model,
                           properties=padded.properties, step_config=padded.step_config,
                           grid=dataclasses.replace(padded.grid, use_pallas_slotmajor=False))
    pform = getattr(k5._forms, form)
    kw = dict(q_vals=vals, s_vals=vals, scalars=(1.0 / 2700.0,)) if form == "forces" else {}
    _check_slot_kernel(tpp, tpp.pallas_pair_reduce, tpp.pallas_pair_reduce_ref, pform,
                       pos, mask, walls if boundary else (pos, mask), k5._consts, kw)


@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_sm_rebucket_kernel_dfsph_payload_bit_equal(device, dcase, shift):
    """K4 with the DFSPH padded step's payload [v*(2) | kappa | stiffness]."""
    solvers, (pos, mask), _, vals = dcase
    grid = solvers["k3"].grid
    adv = pos.clone()
    adv[..., 0] += shift * grid.cell_size  # 0.6 cells crowds cells: forced overflow
    noise = torch.rand(adv.shape, generator=torch.Generator().manual_seed(4)) - 0.5
    adv = adv + noise.to(device) * 0.2 * grid.cell_size
    values = torch.cat([vals["v"], vals["k"][..., None], vals["rho"][..., None]], dim=-1)
    assert values.shape[-1] == 4
    out = smr.sm_rebucket(adv, mask, values, grid)
    ref = smr.sm_rebucket_ref(adv, mask, values, grid)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        assert torch.equal(a, b)
    if shift:
        assert int(out[3]) > 0


def test_tile_pair_kernel_refuses_what_cannot_fit(device, dcase):
    """A source space too deep for one block's shared memory is refused with a
    message before any launch."""
    solvers, (pos, mask), _, _ = dcase
    ny, nx, _ = mask.shape
    deep = torch.zeros((ny, nx, 5000, 2), device=device)
    deep_mask = torch.zeros((ny, nx, 5000), dtype=torch.bool, device=device)
    before = dict(tpp.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        tpp.pallas_pair_reduce(solvers["k5"]._padded_forms.ctx, pos, mask, deep, deep_mask,
                               solvers["k5"]._consts)
    assert tpp.LAUNCHES == before


def _bf16(geom, grid):
    """K1's bf16 geometry of a plane-form index space on `grid`."""
    return plane_geom(geom.pos, geom.mask, dataclasses.replace(grid, pair_dtype="bfloat16"))


@pytest.mark.parametrize("form", ["ctx", "ctx_post", "visc_gravity", "err_ki",
                                  "delta_ki", "corr_v"])
def test_pair_kernel_bf16_matches_twin(device, case, form):
    """K1's DFSPH forms with bf16 operands: rebased bf16 geometry, values
    rounded to bf16 at load, f32 math."""
    solver, ctx, bgeom, vals = case
    pform, src, kw = _operands(solver, ctx, bgeom, vals, form)
    grid = solver.grid
    q = _bf16(PlaneGeom(ctx.pos.to(device), ctx.mask.to(device)), grid)
    s = q if src.pos is ctx.pos else _bf16(
        PlaneGeom(src.pos.to(device), src.mask.to(device)), grid)
    kw = _to(device, kw)
    name = f"{pform.name}_bf16"
    before = pr.LAUNCHES[name]
    out = pr.pair_reduce(pform, q, s, solver._consts, **kw)
    assert pr.LAUNCHES[name] == before + 1
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, s, solver._consts.radius_sq,
                             post_fn=pform.post_fn, n_acc=pform.n_acc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert float(ref.abs().sum()) > 0


@pytest.mark.parametrize("form", ["density", "stat", "forces"])
def test_pair_kernel_bf16_wcsph_forms_match_twin(device, wcase, form):
    _, plane, (pos, mask), walls, (pres, rho, v) = wcase
    pform = getattr(plane._forms, form)
    q = _bf16(PlaneGeom(to_planes(pos), to_planes(mask)), plane.grid)
    s = _bf16(PlaneGeom(to_planes(walls[0]), to_planes(walls[1])), plane.grid) \
        if form == "stat" else q
    pv = (to_planes(pres), to_planes(rho), to_planes(v))
    kw = dict(q_vals=pv, s_vals=pv, scalars=(1.0 / 2700.0,)) if form == "forces" else {}
    out = pr.pair_reduce(pform, q, s, plane._consts, **kw)
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, s, plane._consts.radius_sq,
                             **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert float(ref.abs().sum()) > 0


@pytest.mark.parametrize("spread", [False, True])
@pytest.mark.parametrize("probe,chains", [("fma", 4), ("fma", 8), ("mix", 8)])
def test_vpu_probe_kernels_match_twins(device, probe, chains, spread):
    """K6 at a tenth of the probe's element count, on the TPU probe's constant
    input and on a seeded one spread across the mix's 0.5."""
    n = vp.N_ELEMENTS // 10
    x = vp.spread_input(device, n) if spread else vp.probe_input(device, n)
    run, ref = {"fma": (vp.fma_probe, vp.fma_probe_ref),
                "mix": (vp.mix_probe, vp.mix_probe_ref)}[probe]
    key = f"{probe}{chains}"
    before = vp.LAUNCHES[key]
    out = run(x, chains)
    assert vp.LAUNCHES[key] == before + 1
    twin = ref(x, chains)
    torch.cuda.synchronize()
    if probe == "mix":
        assert torch.equal(out.view(torch.int32), twin.view(torch.int32))
    else:
        torch.testing.assert_close(out, twin, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("p,ps", [(5, 5), (7, 3), (12, 12), (12, 40), (7, 40)])
def test_probe_ctx_kernel_matches_twin(device, p, ps):
    """K7 (K1's kernel with the probe's statement, masks read from plane 2)
    at the probe's check shape: P 5 (the check), 7 and 12 (beyond the first
    K7's P <= 8), sources of the same space or another of Ps 3 or 40 (two
    live words a cell); bit-equal to its twin, one launch a call, and within
    the probe's check of K1's ctx form (another statement of the same sums)."""
    d = pc.CHECK_SHAPE
    q = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], p, d["h"]), device)
    s = q if ps == p else pc.probe_planes(
        *pc.probe_inputs(d["ny"], d["nx"], ps, d["h"], seed=1), device)
    before = pc.LAUNCHES["probe_ctx"]
    out = pc.ctx_pass(q, s, d["h"], d["m"])
    assert pc.LAUNCHES["probe_ctx"] == before + 1
    ref = pc.ctx_pass_ref(q, s, d["h"], d["m"])
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert float(ref[4].sum()) > 0
    if ps == 40:
        assert int((s[2] > 0).sum(0).max()) > 32  # cells of two live words
    assert pc.agree(out, pc.k1_ctx_call(q, s, d["h"], d["m"])())


def _edge_slots(rng, ny, nx, pp, h, fill):
    """Plane-form slots with random, non-compacted liveness (any slot of a cell
    may be live); positions near their own cell."""
    mask = rng.random((ny, nx, pp)) < fill
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
    pos = cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h
    return pos.astype(np.float32), mask


@pytest.fixture(scope="module")
def edge(device):
    """K1's edge cases on one 23 x 37 grid (a multiple of no tile side), P 5:
    random non-compacted masks; a cell whose only live slot is the last; a
    fully live cell; the boundary space with Pb 3 != P; the 8 x 16 cell tile
    at rows 8-15, cols 16-31 without a live query (an air tile of the default
    shape, whose halo holds live sources)."""
    rng = np.random.default_rng(7)
    world = FluidParticleWorld(2.0, 400.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx, p, pb = 23, 37, 5, 3
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p,
                           use_pallas_slotmajor=True)
    common = dict(viscosity_model=XSPHViscosityModel(h), properties=world.properties,
                  grid=grid)
    dfsph = DFSPHPlaneSolver(**common, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5))
    wcsph = WCSPHPlaneSolver(**common, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 0.2))
    pos, mask = _edge_slots(rng, ny, nx, p, h, 0.5)
    mask[3, 4] = [False] * (p - 1) + [True]
    mask[5, 6] = True
    mask[8:16, 16:32] = False
    bpos, bmask = _edge_slots(rng, ny, nx, pb, h, 0.4)
    fluid = PlaneGeom(to_planes(torch.as_tensor(pos)).to(device),
                      to_planes(torch.as_tensor(mask)).to(device))
    walls = PlaneGeom(to_planes(torch.as_tensor(bpos)).to(device),
                      to_planes(torch.as_tensor(bmask)).to(device))
    shape = (p, ny, nx)
    vals = {k: _planes(rng, lead + shape, scale, offset).to(device)
            for k, lead, scale, offset in (("v", (2,), 2.0, -1.0), ("k", (), 50.0, -25.0),
                                           ("rho", (), 30.0, 100.0), ("pres", (), 500.0, 0.0),
                                           ("sgs", (2,), 40.0, -20.0), ("dens", (), 5.0, 100.0),
                                           ("alpha", (), 1e-3, 0.0), ("nt", (), 18.0, 0.0))}
    vals["nt"] = torch.floor(vals["nt"])
    return dfsph, wcsph, fluid, walls, vals


def _edge_operands(edge, form, q):
    """(solver, form, source geometry, keyword operands) of one K1 form on the
    edge case; `q` is the fluid geometry in the operand mode under test. A
    *_phys form takes the solvers with physical viscosity."""
    dfsph, wcsph, fluid, walls, vals = edge
    if form.endswith("_phys"):
        dfsph, wcsph, form = _physical(dfsph), _physical(wcsph), form.removesuffix("_phys")
    s_walls = walls if q.rebase_cell is None else _bf16(walls, dfsph.grid)
    f, w = dfsph._forms, wcsph._forms
    v, k, rho, dt = vals["v"], vals["k"], vals["rho"], 1.0 / 2700.0
    stat = pr.pair_reduce_ref(f.ctx.term_fn, 5, q, s_walls, dfsph._consts.radius_sq)
    wv = (vals["pres"], rho, v)
    return {
        "ctx": (dfsph, f.ctx, s_walls, {}),
        "ctx_post": (dfsph, f.ctx_post, q, dict(post_planes=(stat,))),
        "visc_gravity": (dfsph, f.visc_gravity, q, dict(q_vals=(v,), s_vals=(v, rho),
                                                        scalars=(dt,))),
        "err_ki": (dfsph, f.err_ki, q, dict(q_vals=(v,), s_vals=(v,), scalars=(dt,),
                                            post_planes=(v, vals["sgs"], vals["dens"],
                                                         vals["alpha"]))),
        "delta_ki": (dfsph, f.delta_ki, q, dict(q_vals=(v,), s_vals=(v,), post_planes=(
            v, vals["sgs"], vals["nt"], vals["alpha"]))),
        "corr_v": (dfsph, f.corr_v, q, dict(q_vals=(k,), s_vals=(k,), scalars=(1234.5,),
                                            post_planes=(v, k, vals["sgs"]))),
        "visc": (dfsph, f.visc, q, dict(q_vals=(v,), s_vals=(v, rho), scalars=(dt,))),
        "div": (dfsph, f.div, q, dict(q_vals=(v,), s_vals=(v,))),
        "corr": (dfsph, f.corr, q, dict(q_vals=(k,), s_vals=(k,))),
        "wcsph_density": (wcsph, w.density, q, {}),
        "wcsph_stat": (wcsph, w.stat, s_walls, {}),
        "wcsph_forces": (wcsph, w.forces, q, dict(q_vals=wv, s_vals=wv, scalars=(dt,))),
    }[form]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(pr.cuda_build.PAIR_FORMS))
def test_pair_kernel_edge_cases_bit_equal(device, edge, form, bf16):
    """Every K1 launcher on the edge case, bit-equal to its twin with the
    chosen launch shape and with every shape the tile sweep times (each query
    sums its live candidates in one order whatever the tile)."""
    dfsph, _, fluid, _, _ = edge
    q = _bf16(fluid, dfsph.grid) if bf16 else fluid
    solver, pform, src, kw = _edge_operands(edge, form, q)
    name = f"{pform.name}_bf16" if bf16 else pform.name
    before = pr.LAUNCHES[name]
    out = pr.pair_reduce(pform, q, src, solver._consts, **kw)
    assert pr.LAUNCHES[name] == before + 1
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, src, solver._consts.radius_sq,
                             post_fn=pform.post_fn, n_acc=pform.n_acc, **kw)
    outs = [pr.launch(pform, q, src, solver._consts, kw.get("q_vals", ()),
                      kw.get("s_vals", ()), kw.get("scalars", ()),
                      kw.get("post_planes", ()), tile) for tile in tile_sweep.K1_SHAPES]
    torch.cuda.synchronize()
    assert pr.LAUNCHES[name] == before + 1  # `launch` counts nothing
    for o in [out, *outs]:
        assert torch.equal(o.view(torch.int32), ref.view(torch.int32))
    live = q.mask.expand_as(out)
    assert (out[~live] == 0).all() and float(ref[live].abs().sum()) > 0
    assert (out[:, :, 8:16, 16:32] == 0).all()  # the air tile


def test_pair_kernel_refuses_what_cannot_fit(device, edge):
    """A source space too deep for any cell tile's shared memory is refused
    before any launch; 33 source slots (two live words a cell), refused
    before K1 took several words, now run and equal the twin."""
    dfsph, _, fluid, _, _ = edge
    _, ny, nx = fluid.mask.shape
    deep = PlaneGeom(torch.zeros((2, 5000, ny, nx), device=device),
                     torch.zeros((5000, ny, nx), dtype=torch.bool, device=device))
    before = dict(pr.LAUNCHES)
    with pytest.raises(ValueError, match="no cell tile"):
        pr.pair_reduce(dfsph._forms.ctx, fluid, deep, dfsph._consts)
    assert pr.LAUNCHES == before
    pos = fluid.pos[:, :1].repeat(1, 33, 1, 1) + 0.01 * dfsph.grid.cell_size * torch.arange(
        33, device=device)[None, :, None, None]
    ok = PlaneGeom(pos.contiguous(), fluid.mask[:1].repeat(33, 1, 1).contiguous())
    out = pr.pair_reduce(dfsph._forms.ctx, fluid, ok, dfsph._consts)
    ref = pr.pair_reduce_ref(dfsph._forms.ctx.term_fn, 5, fluid, ok, dfsph._consts.radius_sq)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert pr.LAUNCHES["ctx"] == before["ctx"] + 1 and float(ref[4].sum()) > 0


def _bits(outs):
    return [o.contiguous().view(torch.int32) if o.dtype == torch.float32 else o for o in outs]


@pytest.mark.parametrize("label", ["outside", "borders", "negzero", "overflow"])
@pytest.mark.parametrize("d", [2, 4])
def test_rebucket_kernel_edge_cases_bit_equal(device, edge, label, d):
    """K2 (one launch: move codes, scan, mask and drop count) bit-equal to its
    twin: slots moved far outside the grid (clamped codes, negative
    coordinates), positions exactly on cell borders, a -0.0 payload (written
    as +0.0 by both), forced overflow with equal drop counts; payloads of
    D = 2 and D = 4 value planes."""
    dfsph, _, fluid, _, vals = edge
    grid = dfsph.grid
    h = grid.cell_size
    p, ny, nx = fluid.mask.shape
    rng = np.random.default_rng(11)
    pos = fluid.pos.clone()
    live = fluid.mask
    if label == "outside":
        far = torch.as_tensor(rng.uniform(-4.0, 4.0, (2, p, ny, nx)).astype(np.float32))
        pos = pos + far.to(device) * h * (torch.rand((p, ny, nx)) < 0.3).to(device)
        pos[:, :, :, 0] -= 3.0 * h  # negative x in the first column
    elif label == "borders":
        iy, ix = torch.meshgrid(torch.arange(ny), torch.arange(nx), indexing="ij")
        step = torch.as_tensor(rng.integers(-1, 2, (2, p, ny, nx)))
        pos = torch.stack([(ix + step[0]) * h, (iy + step[1]) * h]).to(torch.float32)
        pos = pos.to(device)
    elif label == "overflow":
        pos[0] += 0.6 * h  # crowds cells
    payload = torch.cat([vals["v"], vals["k"][None], vals["rho"][None]])[:d].clone()
    if label == "negzero":
        payload[0] = torch.where(live, -0.0, payload[0])
    out = rb.rebucket(pos, live, payload, grid)
    ref = rb.rebucket_ref(pos, live, payload, grid)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(_bits(out), _bits(ref)))
    if label == "overflow":
        assert int(out[3]) > 0
    else:
        assert int(out[1].sum()) + int(out[3]) == int(live.sum())
    if label == "negzero":
        assert not torch.signbit(out[2][0]).any()
    if label == "outside":
        assert int(out[1].sum()) > 0


def test_rebucket_planes_is_one_launch_without_a_copy(device, case):
    """The DFSPH step's payload passed by pointer gives the stacked call's
    bits, in the parts' shapes, as one counted launch."""
    solver, ctx, _, vals = case
    pos, mask = ctx.pos.to(device), ctx.mask.to(device)
    v, k, rho = vals["v"].to(device), vals["k"].to(device), vals["rho"].to(device)
    before = rb.LAUNCHES["rebucket"]
    new_pos, new_mask, (nv, nk, nr), drops = rb.rebucket_planes(pos, mask, (v, k, rho),
                                                                 solver.grid)
    assert rb.LAUNCHES["rebucket"] == before + 1
    assert nv.shape == v.shape and nk.shape == k.shape and nr.shape == rho.shape
    ref = rb.rebucket_ref(pos, mask, torch.cat([v, k[None], rho[None]]), solver.grid)
    torch.cuda.synchronize()
    got = (new_pos, new_mask, torch.cat([nv, nk[None], nr[None]]), drops)
    assert all(torch.equal(a, b) for a, b in zip(_bits(got), _bits(ref)))


def _k4_case(device, p, ny, nx, fill, seed, full=False):
    """A ragged slot grid (ny, nx multiples of no K4 tile side) of occupancy
    p: compacted live slots near their own cell (every slot of a `fill`
    share of the cells if `full`), a velocity, kappa and stiffness payload
    with -0.0 on some live slots."""
    rng = np.random.default_rng(seed)
    world = FluidParticleWorld(2.0, 400.0, 100.0)
    h = world.properties.smoothing_length
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p)
    count = (p if full else rng.integers(0, p + 1, (ny, nx))) * (rng.random((ny, nx)) < fill)
    mask = np.arange(p)[None, None, :] < count[..., None]
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
    pos = np.where(mask[..., None], cell + rng.random((ny, nx, p, 2)) * h, 0.0)
    vals = rng.standard_normal((ny, nx, p, 4)).astype(np.float32)
    vals[..., 0] = np.where(rng.random((ny, nx, p)) < 0.1, -0.0, vals[..., 0])
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    return grid, t(pos.astype(np.float32)), t(mask), t(vals)


@pytest.mark.parametrize("overflow", [False, True], ids=["advect", "overflow"])
@pytest.mark.parametrize("widths", [(2,), (2, 1, 1)], ids=["d2", "d4"])
@pytest.mark.parametrize("p,ny,nx", [(1, 23, 37), (6, 23, 37), (40, 11, 37),
                                     (smr.STAGED_MAX_P + 8, 5, 7)],
                         ids=["p1", "p6", "p40", "p_direct"])
def test_sm_rebucket_parts_kernel_bit_equal(device, p, ny, nx, widths, overflow):
    """K4 through the parts entry (one counted launch, the parts by pointer)
    bit-equal to its twin on ragged grids: P = 1, P = 6, P = 40 (two live
    words a staged cell) and P beyond the staged route (the one-thread-per-
    cell route of the same launch); the WCSPH (D = 2) and DFSPH (D = 4)
    payloads; with and without forced overflow; -0.0 comes out +0.0."""
    grid, pos, mask, vals = _k4_case(device, p, ny, nx, 0.7, seed=20 + p, full=overflow)
    h = grid.cell_size
    noise = torch.rand(pos.shape, generator=torch.Generator().manual_seed(p)) - 0.5
    adv = pos + noise.to(device) * 0.3 * h
    if overflow:
        adv[..., 0] += 0.6 * h  # crowds cells
    k = 0
    parts = []
    for c in widths:
        parts.append(vals[..., k].contiguous() if c == 1 else vals[..., k:k + c].contiguous())
        k += c
    values = vals[..., :k].contiguous()
    before = smr.LAUNCHES["sm_rebucket"]
    new_pos, new_mask, new_parts, drops = smr.sm_rebucket_parts(adv, mask, tuple(parts), grid)
    assert smr.LAUNCHES["sm_rebucket"] == before + 1
    assert [t.shape for t in new_parts] == [t.shape for t in parts]
    ref = smr.sm_rebucket_ref(adv, mask, values, grid)
    torch.cuda.synchronize()
    stacked = torch.cat([v[..., None] if v.ndim == 3 else v for v in new_parts], dim=-1)
    got = _bits((new_pos, new_mask, stacked, drops))
    for what, a, b in zip(("positions", "mask", "payload", "drops"), got, _bits(ref)):
        assert torch.equal(a, b), f"{what}: {int((a != b).sum())} elements differ"
    if overflow:
        assert int(drops) > 0
    else:
        assert int(new_mask.sum()) + int(drops) == int(mask.sum())
    assert not torch.signbit(stacked[stacked == 0]).any()  # -0.0 comes out +0.0


def test_sm_rebucket_steps_are_one_launch(device):
    """The padded steps call K4 once per step through the parts entry: 20
    steps of the WCSPH padded solver count 20 launches of it."""
    world = double_dam_break(3_000)
    solver, boundary = bench_solver("wcsph_padded_k5", world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    before = smr.LAUNCHES["sm_rebucket"]
    carry, _ = solver.simulate(carry, boundary, 20)
    assert smr.LAUNCHES["sm_rebucket"] == before + 20


@pytest.fixture(scope="module")
def deep(device, dcase):
    """A source space of Ps = 40 slots crowded into a few cells (more than 32
    live slots a cell: two live words) on dcase's 23 x 37 grid, with source
    values of its own shape, and the WCSPH padded solver on K5."""
    solvers, (pos, mask), _, vals = dcase
    ny, nx, _ = mask.shape
    ps = 40
    rng = np.random.default_rng(8)
    h = solvers["k5"].grid.cell_size
    count = np.zeros((ny, nx), dtype=np.int64)
    count[9:12, 14:19] = rng.integers(30, ps + 1, (3, 5))
    count[2:5, 30:35] = rng.integers(0, 20, (3, 5))
    smask = np.arange(ps)[None, None, :] < count[..., None]
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
    spos = np.where(smask[..., None], cell + rng.random((ny, nx, ps, 2)) * h, 0.0)
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    sv = dict(v=t((rng.random((ny, nx, ps, 2)) * 2 - 1).astype(np.float32)),
              k=t((rng.random((ny, nx, ps)) * 50 - 25).astype(np.float32)),
              rho=t(np.where(smask, 100 + 30 * rng.random((ny, nx, ps)), 0).astype(np.float32)),
              pres=t((rng.random((ny, nx, ps)) * 500).astype(np.float32)))
    k5 = solvers["k5"]
    wcsph = WCSPHPaddedSolver(viscosity_model=k5.viscosity_model, properties=k5.properties,
                              grid=k5.grid,
                              step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 0.2))
    qpres = torch.where(mask, torch.rand(mask.shape, generator=torch.Generator().manual_seed(3))
                        .to(device) * 500.0, 0.0)
    return k5, wcsph, (t(spos.astype(np.float32)), t(smask)), sv, dict(vals, pres=qpres)


@pytest.mark.parametrize("form", ["dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc",
                                  "wcsph_density", "wcsph_stat", "wcsph_forces"])
def test_tile_pair_kernel_deep_sources_match_twin(device, dcase, deep, form):
    """Every K5 form with Ps = 40 > 32 source slots (two live words a cell),
    against its twin, and with every launch shape of the tile sweep bit-equal
    to the chosen one (each query sums its live candidates in one order
    whatever the tile)."""
    _, (pos, mask), _, _ = dcase
    k5, wcsph, src, sv, qv = deep
    f, w = k5._padded_forms, wcsph._forms
    dt = (1.0 / 2700.0,)
    wq = (qv["pres"], qv["rho"], qv["v"])
    ws = (sv["pres"], sv["rho"], sv["v"])
    pform, kw, consts = {
        "dfsph_ctx": (f.ctx, {}, k5._consts),
        "dfsph_div": (f.div, dict(q_vals=(qv["v"],), s_vals=(sv["v"],)), k5._consts),
        "dfsph_corr": (f.corr, dict(q_vals=(qv["k"],), s_vals=(sv["k"],)), k5._consts),
        "dfsph_visc": (f.visc, dict(q_vals=(qv["v"],), s_vals=(sv["v"], sv["rho"]),
                                    scalars=dt), k5._consts),
        "wcsph_density": (w.density, {}, wcsph._consts),
        "wcsph_stat": (w.stat, {}, wcsph._consts),
        "wcsph_forces": (w.forces, dict(q_vals=wq, s_vals=ws, scalars=dt), wcsph._consts),
    }[form]
    assert pform.name == form
    _check_slot_kernel(tpp, tpp.pallas_pair_reduce, tpp.pallas_pair_reduce_ref, pform, pos,
                       mask, src, consts, kw)
    out = tpp.pallas_pair_reduce(pform, pos, mask, *src, consts, **kw)
    n_sv = len(smp._comps(kw.get("s_vals", ())))
    outs = [tpp.launch(pform, pos, mask, *src, consts, kw.get("q_vals", ()),
                       kw.get("s_vals", ()), kw.get("scalars", ()), tile)
            for tile in tile_sweep.SHAPES
            if tpp.smem_bytes(*tile[:2], mask.shape[2], src[1].shape[2], n_sv) <= tpp.SMEM_LIMIT]
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o.view(torch.int32), out.view(torch.int32))


def _slot_space(rng, ny, nx, pp, h, fill, dead_rho):
    """A slot-layout space (ny, nx, pp) with random non-compacted liveness,
    live positions near their own cell (dead ones 0), and values: v (.., 2),
    k, rho (dead slots hold `dead_rho`), pres."""
    mask = rng.random((ny, nx, pp)) < fill
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * h
    pos = np.where(mask[..., None], cell + (rng.random((ny, nx, pp, 2)) * 1.1 - 0.05) * h,
                   0.0)
    f = lambda *tail: rng.random((ny, nx, pp) + tail)  # noqa: E731
    vals = dict(v=f(2) * 2 - 1, k=f() * 50 - 25, rho=np.where(mask, 100 + 30 * f(), dead_rho),
                pres=f() * 500)
    return (pos.astype(np.float32), mask), {k: v.astype(np.float32) for k, v in vals.items()}


@pytest.fixture(scope="module")
def k3case(device):
    """K3's synthetic cases on a ragged 23 x 37 grid (a multiple of no tile
    side): query spaces of P = 1 and P = 40 whose 8 x 8 cell tile at rows
    8-15, cols 8-15 holds no live query (an air tile of the chosen shape),
    dead slots holding rho = 0; a source space of Ps = 40 (cells of more
    than 32 live slots, two live words) whose dead slots hold rho = NaN; and
    the WCSPH and DFSPH padded solvers on the K3 route."""
    rng = np.random.default_rng(12)
    world = FluidParticleWorld(2.0, 400.0, 100.0)
    h = world.properties.smoothing_length
    ny, nx = 23, 37
    t = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    spaces = {}
    for name, pp, fill, dead in (("p1", 1, 0.7, 0.0), ("p40", 40, 0.5, 0.0),
                                 ("deep", 40, 0.9, np.nan)):
        (pos, mask), vals = _slot_space(rng, ny, nx, pp, h, fill, dead)
        if name != "deep":
            mask[8:16, 8:16] = False
            pos[8:16, 8:16] = 0.0
        spaces[name] = ((t(pos), t(mask)), {k: t(v) for k, v in vals.items()})
    assert int(spaces["deep"][0][1].sum(-1).max()) > 32
    grid = DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=1,
                           use_pallas_slotmajor=True)
    common = dict(viscosity_model=XSPHViscosityModel(h), properties=world.properties,
                  grid=grid)
    dfsph = DFSPHPaddedSolver(**common, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5))
    wcsph = WCSPHPaddedSolver(**common, step_config=AdaptiveTimeStep(1 / 360, 1 / 24000, 0.2))
    return dfsph, wcsph, spaces


def _k3_form(dfsph, wcsph, form, qv, sv):
    """(form, consts, keyword operands) of one K3 or K5 form on query values
    `qv` and source values `sv` (the _slot_space dicts); a *_phys form takes
    the solvers with physical viscosity."""
    if form.endswith("_phys"):
        dfsph, wcsph, form = _physical(dfsph), _physical(wcsph), form.removesuffix("_phys")
    f, w = dfsph._padded_forms, wcsph._forms
    dt = (1.0 / 2700.0,)
    wq, ws = (qv["pres"], qv["rho"], qv["v"]), (sv["pres"], sv["rho"], sv["v"])
    return {
        "dfsph_ctx": (f.ctx, dfsph._consts, {}),
        "dfsph_stat": (f.stat, dfsph._consts, {}),
        "dfsph_div": (f.div, dfsph._consts, dict(q_vals=(qv["v"],), s_vals=(sv["v"],))),
        "dfsph_corr": (f.corr, dfsph._consts, dict(q_vals=(qv["k"],), s_vals=(sv["k"],))),
        "dfsph_visc": (f.visc, dfsph._consts, dict(q_vals=(qv["v"],),
                                                   s_vals=(sv["v"], sv["rho"]), scalars=dt)),
        "wcsph_density": (w.density, wcsph._consts, {}),
        "wcsph_stat": (w.stat, wcsph._consts, {}),
        "wcsph_forces": (w.forces, wcsph._consts, dict(q_vals=wq, s_vals=ws, scalars=dt)),
    }[form]


def _check_k3(pform, consts, pos, mask, src, kw, shapes=()):
    """K3 through its wrapper (one counted launch) bit-equal to its twin, dead
    query slots zero, and through `launch` with every tile of `shapes` that
    fits bit-equal to the chosen one."""
    before = smp.LAUNCHES[pform.name]
    out = smp.sm_pair_reduce(pform, pos, mask, *src, consts, **kw)
    assert smp.LAUNCHES[pform.name] == before + 1
    twin = smp.sm_pair_reduce_ref(pform.term_fn, pform.n_out, pos, mask, *src,
                                  consts.radius_sq, **kw)
    n_sv = len(smp._comps(kw.get("s_vals", ())))
    outs = [smp.launch(pform, pos, mask, *src, consts, kw.get("q_vals", ()),
                       kw.get("s_vals", ()), kw.get("scalars", ()), tile)
            for tile in shapes
            if tpp.smem_bytes(*tile[:2], mask.shape[2], src[1].shape[2], n_sv) <= tpp.SMEM_LIMIT]
    torch.cuda.synchronize()
    assert smp.LAUNCHES[pform.name] == before + 1  # `launch` counts nothing
    assert torch.equal(out.view(torch.int32), twin.view(torch.int32))
    assert (out[~mask] == 0).all() and bool(torch.isfinite(out).all())
    for o in outs:
        assert torch.equal(o.view(torch.int32), out.view(torch.int32))
    return out


@pytest.mark.parametrize("source", ["same", "deep"])
@pytest.mark.parametrize("space", ["p1", "p40"])
@pytest.mark.parametrize("form", list(smp.LAUNCHES))
def test_sm_pair_kernel_edge_cases_bit_equal(device, k3case, form, space, source):
    """Every K3 form on the synthetic cases: P = 1 and P = 40 query spaces
    against their own space (dead rho = 0) and against the Ps = 40 source
    space (two live words a cell, dead rho = NaN), bit-equal to the twin with
    the chosen tile and with every tile the sweep times; the air tile writes
    zeros."""
    dfsph, wcsph, spaces = k3case
    (pos, mask), qv = spaces[space]
    src, sv = spaces[source] if source == "deep" else spaces[space]
    pform, consts, kw = _k3_form(dfsph, wcsph, form, qv, sv)
    assert pform.name == form
    out = _check_k3(pform, consts, pos, mask, src, kw, tile_sweep.SHAPES)
    assert (out[8:16, 8:16] == 0).all()  # the air tile
    assert float(out.abs().sum()) > 0


@pytest.mark.parametrize("kind,steps", [("wcsph_padded", 3), ("dfsph_padded", 55)])
def test_sm_pair_kernel_forms_bit_equal_on_3k_states(device, kind, steps):
    """K3's forms as a padded step calls them (tools/kernel_times.py's calls,
    seeded noise) on the 3k double dam-break state of its solver after
    `steps` steps (DFSPH in wall contact), bit-equal to the twin, the step's
    pass against the boundary summing something."""
    from yasph2d_tpu_torch.tools.kernel_times import padded_calls

    world = double_dam_break(3_000)
    solver, boundary = bench_solver(kind, world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, steps)
    calls = padded_calls(solver, boundary, carry, np.random.default_rng(6))
    for label, (form, q, src, kw) in calls.items():
        out = _check_k3(form, solver._consts, *q, src, kw)
        # the WCSPH columns reach the walls after step 3 (chip_smoke.py)
        assert label == "wcsph_stat" or float(out.abs().sum()) > 0, label


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(pr.cuda_build.PAIR_FORMS))
def test_pair_kernel_deep_sources_bit_equal(device, edge, form, bf16):
    """Every K1 launcher with a source space of Ps = 40 (cells of more than 32
    live slots: two live words a cell) in both operand modes, bit-equal to its
    twin with the chosen launch shape."""
    dfsph, wcsph, fluid, _, vals = edge
    if form.endswith("_phys"):
        dfsph, wcsph = _physical(dfsph), _physical(wcsph)
    p, ny, nx = fluid.mask.shape
    rng = np.random.default_rng(13)
    h = dfsph.grid.cell_size
    (spos, smask), sv = _slot_space(rng, ny, nx, 40, h, 0.9, 0.0)
    deep = PlaneGeom(to_planes(torch.as_tensor(spos)).to(device),
                     to_planes(torch.as_tensor(smask)).to(device))
    assert int(deep.mask.sum(0).max()) > 32
    sv = {k: to_planes(torch.as_tensor(v)).to(device) for k, v in sv.items()}
    q, src = (_bf16(fluid, dfsph.grid), _bf16(deep, dfsph.grid)) if bf16 else (fluid, deep)
    f, w = dfsph._forms, wcsph._forms
    v, k, rho, dt = vals["v"], vals["k"], vals["rho"], 1.0 / 2700.0
    stat = pr.pair_reduce_ref(f.ctx.term_fn, 5, q, src, dfsph._consts.radius_sq)
    solver, pform, kw = {
        "ctx": (dfsph, f.ctx, {}),
        "ctx_post": (dfsph, f.ctx_post, dict(post_planes=(stat,))),
        "visc_gravity": (dfsph, f.visc_gravity, dict(q_vals=(v,), s_vals=(sv["v"], sv["rho"]),
                                                     scalars=(dt,))),
        "err_ki": (dfsph, f.err_ki, dict(q_vals=(v,), s_vals=(sv["v"],), scalars=(dt,),
                                         post_planes=(v, vals["sgs"], vals["dens"],
                                                      vals["alpha"]))),
        "delta_ki": (dfsph, f.delta_ki, dict(q_vals=(v,), s_vals=(sv["v"],), post_planes=(
            v, vals["sgs"], vals["nt"], vals["alpha"]))),
        "corr_v": (dfsph, f.corr_v, dict(q_vals=(k,), s_vals=(sv["k"],), scalars=(1234.5,),
                                         post_planes=(v, k, vals["sgs"]))),
        "visc": (dfsph, f.visc, dict(q_vals=(v,), s_vals=(sv["v"], sv["rho"]),
                                     scalars=(dt,))),
        "div": (dfsph, f.div, dict(q_vals=(v,), s_vals=(sv["v"],))),
        "corr": (dfsph, f.corr, dict(q_vals=(k,), s_vals=(sv["k"],))),
        "wcsph_density": (wcsph, w.density, {}),
        "wcsph_stat": (wcsph, w.stat, {}),
        "wcsph_forces": (wcsph, w.forces, dict(q_vals=(vals["pres"], rho, v),
                                               s_vals=(sv["pres"], sv["rho"], sv["v"]),
                                               scalars=(dt,))),
    }[form.removesuffix("_phys")]
    assert pform.name == form
    name = f"{pform.name}_bf16" if bf16 else pform.name
    before = pr.LAUNCHES[name]
    out = pr.pair_reduce(pform, q, src, solver._consts, **kw)
    assert pr.LAUNCHES[name] == before + 1
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, src, solver._consts.radius_sq,
                             post_fn=pform.post_fn, n_acc=pform.n_acc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    live = q.mask.expand_as(out)
    assert (out[~live] == 0).all() and float(ref[live].abs().sum()) > 0


@pytest.mark.parametrize("source", ["same", "deep"])
@pytest.mark.parametrize("space", ["p1", "p40"])
@pytest.mark.parametrize("form", ["dfsph_visc_phys", "wcsph_forces_phys"])
def test_tile_pair_kernel_physical_forms_edge_cases(device, k3case, form, space, source):
    """K5's physical viscosity forms on K3's synthetic cases (P = 1 and
    P = 40 queries, dead rho = 0; the Ps = 40 source space, dead rho = NaN),
    against the twin at K5's tolerance, dead queries zero."""
    dfsph, wcsph, spaces = k3case
    k5 = [dataclasses.replace(s, grid=dataclasses.replace(s.grid, use_pallas_slotmajor=False))
          for s in (dfsph, wcsph)]
    (pos, mask), qv = spaces[space]
    src, sv = spaces[source] if source == "deep" else spaces[space]
    pform, consts, kw = _k3_form(*k5, form, qv, sv)
    assert pform.name == form
    _check_slot_kernel(tpp, tpp.pallas_pair_reduce, tpp.pallas_pair_reduce_ref, pform, pos,
                       mask, src, consts, kw)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("space", ["p1", "p40"])
@pytest.mark.parametrize("form", ["visc_gravity_phys", "wcsph_forces_phys"])
def test_pair_kernel_physical_forms_nan_sources_bit_equal(device, k3case, form, space, bf16):
    """K1's physical viscosity forms in both operand modes, P = 1 and P = 40
    query planes against the Ps = 40 source space whose dead slots hold
    rho = NaN (skipped, never multiplied by 0), bit-equal to the twin."""
    dfsph, wcsph, spaces = k3case
    grid = dfsph.grid
    plane = [_physical(cls(viscosity_model=dfsph.viscosity_model, properties=dfsph.properties,
                           grid=grid, step_config=s.step_config))
             for cls, s in ((DFSPHPlaneSolver, dfsph), (WCSPHPlaneSolver, wcsph))]
    (pos, mask), qv = spaces[space]
    (spos, smask), sv = spaces["deep"]
    assert bool(torch.isnan(sv["rho"][~smask]).all())
    planes = lambda a: to_planes(a).contiguous()  # noqa: E731
    q, src = PlaneGeom(planes(pos), planes(mask)), PlaneGeom(planes(spos), planes(smask))
    if bf16:
        q, src = _bf16(q, grid), _bf16(src, grid)
    qp, sp = ({k: planes(v) for k, v in d.items()} for d in (qv, sv))
    dt = (1.0 / 2700.0,)
    solver, pform, kw = {
        "visc_gravity_phys": (plane[0], plane[0]._forms.visc_gravity, dict(
            q_vals=(qp["v"],), s_vals=(sp["v"], sp["rho"]), scalars=dt)),
        "wcsph_forces_phys": (plane[1], plane[1]._forms.forces, dict(
            q_vals=(qp["pres"], qp["rho"], qp["v"]), s_vals=(sp["pres"], sp["rho"], sp["v"]),
            scalars=dt)),
    }[form]
    assert pform.name == form
    name = f"{form}_bf16" if bf16 else form
    before = pr.LAUNCHES[name]
    out = pr.pair_reduce(pform, q, src, solver._consts, **kw)
    assert pr.LAUNCHES[name] == before + 1
    ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, q, src, solver._consts.radius_sq,
                             post_fn=pform.post_fn, n_acc=pform.n_acc, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    live = q.mask.expand_as(out)
    assert bool(torch.isfinite(out).all()) and (out[~live] == 0).all()
    assert float(ref[live].abs().sum()) > 0


@pytest.mark.parametrize("kind", ["dfsph_plane", "dfsph_padded", "dfsph_padded_k5",
                                  "dfsph_plane_bf16", "wcsph_padded", "wcsph_plane",
                                  "wcsph_padded_k5", "wcsph_plane_bf16"])
def test_physical_solver_gpu_matches_cpu(device, kind):
    """Five adaptive steps of a 3k double dam-break with physical viscosity:
    the *_phys kernels on the GPU, twins on the CPU; equal iteration and drop
    counts and live rows (the tolerances of test_solver_gpu_matches_cpu)."""
    rows, iters = {}, {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        solver, boundary = bench_solver(kind, world, device=dev)
        solver = _physical(solver)
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


@pytest.mark.parametrize("kind", ["dfsph_plane", "dfsph_padded", "dfsph_padded_k5"])
def test_rebuild_every_on_the_card(device, kind):
    """rebuild_every = 3: simulate(10) re-buckets 4 times (three blocks of a
    rebuild and two stale steps, one leftover rebuild), counted at K2 (plane)
    or K4 (padded), and agrees with the CPU twins (test_solver_gpu_matches_cpu's
    tolerances, summed iteration counts)."""
    mod, key = (rb, "rebucket") if kind.startswith("dfsph_plane") else (smr, "sm_rebucket")
    rows, counts = {}, {}
    for dev in (device, torch.device("cpu")):
        world = double_dam_break(3_000)
        solver, boundary = bench_solver(kind, world, device=dev)
        solver = dataclasses.replace(solver, rebuild_every=3)
        carry = solver.init_carry(world.initial_state(device=dev), boundary)
        before = mod.LAUNCHES[key]
        carry, d = solver.simulate(carry, boundary, 10)
        if dev.type == "cuda":
            assert mod.LAUNCHES[key] == before + 4
        counts[dev.type] = (d.density_iterations, d.divergence_iterations, d.neighbor_drops)
        s = solver.export_state(carry)
        r = torch.cat([s.positions, s.densities[:, None]], 1)[s.alive].cpu().numpy()
        rows[dev.type] = r[np.lexsort(r.T)]
    assert counts["cuda"] == counts["cpu"]
    np.testing.assert_allclose(rows["cuda"], rows["cpu"], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ halo forms (sharding)

BANDS = ((0, 8), (8, 16), (16, 23))  # row bands of the 23-row edge grid


def _band(t, r0, r1):
    return t[..., r0:r1, :].contiguous()


def _halo_rows(t, r0, r1):
    """Rows r0 - 1 and r1 of (..., ny, nx) planes stacked as (..., 2, nx);
    zero (dead) where off the grid, as the ends of a mesh receive them."""
    ny = t.shape[-2]
    rows = [t[..., r:r + 1, :] if 0 <= r < ny else torch.zeros_like(t[..., :1, :])
            for r in (r0 - 1, r1)]
    return torch.cat(rows, dim=-2).contiguous()


def _band_geom(g, r0, r1):
    ny = g.mask.shape[-2]
    halo = Halo((_halo_rows(g.pos, r0, r1), _halo_rows(g.mask, r0, r1)), r0, ny)
    return PlaneGeom(_band(g.pos, r0, r1), _band(g.mask, r0, r1), g.rebase_cell, halo)


def _band_kw(kw, r0, r1):
    """A pass's keyword operands on rows [r0, r1), with the source values' halo."""
    out = {k: tuple(_band(t, r0, r1) for t in kw.get(k, ()))
           for k in ("q_vals", "s_vals", "post_planes")}
    out["scalars"] = kw.get("scalars", ())
    out["s_halo"] = tuple(_halo_rows(t, r0, r1) for t in kw.get("s_vals", ()))
    return out


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", list(pr.cuda_build.PAIR_FORMS))
def test_pair_kernel_halo_forms_bit_equal(device, edge, form, bf16):
    """Every K1 halo launcher on three row bands of the edge case (the first
    and last with a dead halo row, as at the ends of a mesh): bit-equal to
    its twin with the chosen launch shape and every shape the tile sweep
    times, and to the one-device kernel's rows of the whole grid; each call
    counted under <form>[_bf16]_halo."""
    dfsph, _, fluid, _, _ = edge
    q = _bf16(fluid, dfsph.grid) if bf16 else fluid
    solver, pform, src, kw = _edge_operands(edge, form, q)
    full = pr.pair_reduce(pform, q, src, solver._consts, **kw)
    name = pform.name + ("_bf16" if bf16 else "") + "_halo"
    for r0, r1 in BANDS:
        qb, sb, kb = _band_geom(q, r0, r1)._replace(halo=None), _band_geom(src, r0, r1), \
            _band_kw(kw, r0, r1)
        before = pr.LAUNCHES[name]
        out = pr.pair_reduce(pform, qb, sb, solver._consts, **kb)
        assert pr.LAUNCHES[name] == before + 1
        ref = pr.pair_reduce_ref(pform.term_fn, pform.n_out, qb, sb, solver._consts.radius_sq,
                                 post_fn=pform.post_fn, n_acc=pform.n_acc, **kb)
        outs = [pr.launch(pform, qb, sb, solver._consts, kb["q_vals"], kb["s_vals"],
                          kb["scalars"], kb["post_planes"], tile, kb["s_halo"])
                for tile in tile_sweep.K1_SHAPES]
        torch.cuda.synchronize()
        for o in [out, *outs]:
            assert torch.equal(o.view(torch.int32), ref.view(torch.int32))
        assert torch.equal(out.view(torch.int32), _band(full, r0, r1).view(torch.int32))
    assert float(full.abs().sum()) > 0


@pytest.mark.parametrize("label", ["outside", "seams", "overflow"])
@pytest.mark.parametrize("d", [2, 4])
def test_rebucket_kernel_halo_form_bit_equal(device, edge, label, d):
    """K2's halo form on three row bands: bit-equal to its twin, and the bands'
    outputs are the one-device re-bucket's rows of the whole grid, with the
    same total drops: slots moved far (clamped codes), slots moved one row
    across each seam, forced overflow."""
    dfsph, _, fluid, _, vals = edge
    grid, h = dfsph.grid, dfsph.grid.cell_size
    p, ny, nx = fluid.mask.shape
    rng = np.random.default_rng(13)
    pos, live = fluid.pos.clone(), fluid.mask
    if label == "outside":
        far = torch.as_tensor(rng.uniform(-4.0, 4.0, (2, p, ny, nx)).astype(np.float32))
        pos = pos + far.to(device) * h * (torch.rand((p, ny, nx)) < 0.3).to(device)
    elif label == "seams":
        step = torch.as_tensor(rng.integers(-1, 2, (p, ny, nx)).astype(np.float32))
        pos[1] += step.to(device) * h
    else:
        pos[1] += 0.6 * h  # crowds cells
    payload = torch.cat([vals["v"], vals["k"][None], vals["rho"][None]])[:d].clone()
    full = rb.rebucket(pos, live, payload, grid)
    drops = 0
    for r0, r1 in BANDS:
        band = dataclasses.replace(grid, ny=r1 - r0)
        halo = Halo((_halo_rows(live, r0, r1), _halo_rows(pos, r0, r1),
                     _halo_rows(payload, r0, r1)), r0, ny)
        args = (_band(pos, r0, r1), _band(live, r0, r1), _band(payload, r0, r1), band)
        before = rb.LAUNCHES["rebucket_halo"]
        out = rb.rebucket(*args, halo=halo)
        assert rb.LAUNCHES["rebucket_halo"] == before + 1
        ref = rb.rebucket_ref(*args, halo=halo)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(_bits(out), _bits(ref)))
        assert all(torch.equal(a, _band(b, r0, r1))
                   for a, b in zip(_bits(out[:3]), _bits(full[:3])))
        drops += int(out[3])
    assert drops == int(full[3])
    if label == "overflow":
        assert drops > 0


def _sharded_rank(group, kind, steps, kick):
    """One gloo rank of test_sharded_plane_steps_equal_one_device: the 3k
    double dam-break, fluid kicked upward by `kick` m/s, `steps` sharded
    steps; (per-step counts, this rank's live slots per step, gathered live
    rows, the launches of the run)."""
    from yasph2d_tpu_torch.parallel.shard_plane import ShardedDFSPHPlane, ShardedWCSPHPlane

    world = double_dam_break(3_000)
    solver, _ = bench_solver(kind, world, device=group.device, ny_multiple=group.size)
    cls = ShardedDFSPHPlane if kind.startswith("dfsph") else ShardedWCSPHPlane
    sharded = cls(group, viscosity_model=solver.viscosity_model,
                  properties=solver.properties, full_grid=solver.grid,
                  step_config=solver.step_config)
    state = world.initial_state(device=group.device)
    state = state._replace(velocities=state.velocities + torch.tensor(
        [0.0, kick], device=group.device))
    carry, bpl = sharded.init(state, world.boundary_dense(solver.grid, device=group.device))
    pr.reset_launch_counts()
    rb.reset_launch_counts()
    counts, live = [], []
    for _ in range(steps):
        carry, d = sharded.simulate(carry, bpl, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
        live.append(int((carry.ctx.mask if kind.startswith("dfsph") else carry.mask).sum()))
    launches = {k: v for k, v in {**pr.LAUNCHES, **rb.LAUNCHES}.items() if v}
    return counts, live, sharded.gather_live_rows(carry).cpu(), launches


@pytest.mark.parametrize("kind", ["dfsph_plane", "dfsph_plane_bf16", "wcsph_plane"])
def test_sharded_plane_steps_equal_one_device(device, kind):
    """Two gloo ranks sharing the card (halo rows staged through the host):
    40 steps of the 3k double dam-break kicked 3 m/s upward, so that the
    columns' tops cross the seam, give the one-device solver's per-step
    iterations and drops and its live rows bit for bit, through the halo
    launchers only."""
    from yasph2d_tpu_torch.parallel import comm

    steps, kick = 40, 3.0
    world = double_dam_break(3_000)
    solver, _ = bench_solver(kind, world, device=device, ny_multiple=2)
    boundary = solver.boundary_planes(world.boundary_dense(solver.grid, device=device))
    state = world.initial_state(device=device)
    state = state._replace(velocities=state.velocities + torch.tensor([0.0, kick],
                                                                        device=device))
    carry = solver.init_carry(state, boundary)
    counts = []
    for _ in range(steps):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive].cpu()
    results = comm.spawn(_sharded_rank, 2, "gloo", [device, device], kind, steps, kick)
    for got_counts, _, got_rows, launches in results:
        assert got_counts == counts
        assert torch.equal(got_rows.view(torch.int32), rows.view(torch.int32))
        assert launches and all(k.endswith("_halo") for k in launches)
    upper = results[1][1]
    assert upper[-1] > upper[0]  # particles crossed the seam into the upper shard


# ------------------------------------------- K5 / K4 halo forms (padded sharding)

SLOT_BANDS = ((0, 8), (8, 16), (16, 23), (0, 23))  # the last: one shard, dead halo


def _slot_halo(t, r0, r1):
    """Rows r0 - 1 and r1 of an (ny, nx, ...) slot tensor as (2, nx, ...), zero
    (dead) off the grid, as the ends of a mesh receive them."""
    rows = [t[r:r + 1] if 0 <= r < t.shape[0] else torch.zeros_like(t[:1])
            for r in (r0 - 1, r1)]
    return torch.cat(rows).contiguous()


@pytest.mark.parametrize("source", ["same", "deep"])
@pytest.mark.parametrize("form", list(tpp.cuda_build.TILE_PAIR_FORMS))
def test_tile_pair_kernel_halo_forms_match_twin(device, k3case, form, source):
    """Every K5 halo launcher on row bands of K3's synthetic P = 40 case (its
    own source, or the Ps = 40 space whose dead slots hold NaN): the two
    inner seams' halo rows hold live slots, the edges' are dead, and one band
    is the whole grid (a one-shard mesh). Each call is one launch counted
    under <form>_halo, agrees with its twin at K5's tolerance, and equals the
    one-device kernel's rows of the whole grid bit for bit (each query sums
    the same candidates in the same order)."""
    dfsph, wcsph, spaces = k3case
    k5 = [dataclasses.replace(s, grid=dataclasses.replace(s.grid, use_pallas_slotmajor=False))
          for s in (dfsph, wcsph)]
    (pos, mask), qv = spaces["p40"]
    (spos, smask), sv = spaces[source] if source == "deep" else spaces["p40"]
    pform, consts, kw = _k3_form(*k5, form, qv, sv)
    assert pform.name == form
    full = tpp.pallas_pair_reduce(pform, pos, mask, spos, smask, consts, **kw)
    name = form + "_halo"
    for r0, r1 in SLOT_BANDS:
        rows = tuple(_slot_halo(t, r0, r1) for t in (spos, smask, *kw.get("s_vals", ())))
        if 0 < r0:
            assert bool(rows[1].any())  # a seam: live halo slots
        kb = {k: tuple(t[r0:r1].contiguous() for t in kw[k])
              for k in ("q_vals", "s_vals") if k in kw}
        args = (pform, pos[r0:r1].contiguous(), mask[r0:r1].contiguous(),
                spos[r0:r1].contiguous(), smask[r0:r1].contiguous())
        before = tpp.LAUNCHES[name]
        out = tpp.pallas_pair_reduce(*args, consts, scalars=kw.get("scalars", ()),
                                     halo=Halo(rows, r0, 23), **kb)
        assert tpp.LAUNCHES[name] == before + 1
        twin = tpp.pallas_pair_reduce_ref(pform.term_fn, pform.n_out, *args[1:],
                                          consts.radius_sq, scalars=kw.get("scalars", ()),
                                          halo=Halo(rows, r0, 23), **kb)
        torch.cuda.synchronize()
        live = args[2][..., None].expand_as(out)
        torch.testing.assert_close(out[live], twin[live], rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(twin[live].abs().max())))
        assert (out[~live] == 0).all()
        assert torch.equal(out.view(torch.int32), full[r0:r1].view(torch.int32))
    assert float(full.abs().sum()) > 0


@pytest.mark.parametrize("source", ["same", "deep"])
@pytest.mark.parametrize("form", list(tpp.cuda_build.TILE_PAIR_FORMS))
def test_tile_pair_kernel_bf16_forms_match_twin(device, k3case, form, source):
    """Every K5 launcher in its bf16 math mode, one-device and halo form, on
    K3's synthetic P = 40 case (its own source, or the Ps = 40 space whose
    dead slots hold NaN) and its row bands: one launch counted under
    <form>_bf16 / <form>_bf16_halo, at K5's tolerance from its twin, and
    each band (rebased on its global rows) the one-device kernel's rows bit
    for bit."""
    dfsph, wcsph, spaces = k3case
    k5 = {dtype: [dataclasses.replace(s, grid=dataclasses.replace(
        s.grid, use_pallas_slotmajor=False, pair_dtype=dtype)) for s in (dfsph, wcsph)]
        for dtype in ("float32", "bfloat16")}
    (pos, mask), qv = spaces["p40"]
    (spos, smask), sv = spaces[source] if source == "deep" else spaces["p40"]
    pform, consts, kw = _k3_form(*k5["bfloat16"], form, qv, sv)
    grid = k5["bfloat16"][0].grid
    assert pform.name == form and consts.radius_sq == tpp.bf16_float(grid.radius_sq)
    name = form + "_bf16"
    before = tpp.LAUNCHES[name]
    full = tpp.pallas_pair_reduce(pform, pos, mask, spos, smask, consts,
                                  rebase=tpp.rebase_of(grid), **kw)
    assert tpp.LAUNCHES[name] == before + 1
    f32_form, f32_consts, _ = _k3_form(*k5["float32"], form, qv, sv)
    f32 = tpp.pallas_pair_reduce(f32_form, pos, mask, spos, smask, f32_consts, **kw)
    assert not torch.equal(full, f32)  # the mode is live
    for r0, r1 in SLOT_BANDS:
        rows = tuple(_slot_halo(t, r0, r1) for t in (spos, smask, *kw.get("s_vals", ())))
        kb = {k: tuple(t[r0:r1].contiguous() for t in kw[k])
              for k in ("q_vals", "s_vals") if k in kw}
        args = (pform, pos[r0:r1].contiguous(), mask[r0:r1].contiguous(),
                spos[r0:r1].contiguous(), smask[r0:r1].contiguous())
        halo_kw = dict(scalars=kw.get("scalars", ()), halo=Halo(rows, r0, 23),
                       rebase=tpp.rebase_of(grid, r0), **kb)
        before = tpp.LAUNCHES[name + "_halo"]
        out = tpp.pallas_pair_reduce(*args, consts, **halo_kw)
        assert tpp.LAUNCHES[name + "_halo"] == before + 1
        twin = tpp.pallas_pair_reduce_ref(pform.term_fn, pform.n_out, *args[1:],
                                          consts.radius_sq, **halo_kw)
        torch.cuda.synchronize()
        live = args[2][..., None].expand_as(out)
        torch.testing.assert_close(out[live], twin[live], rtol=1e-5,
                                   atol=1e-6 * max(1.0, float(twin[live].abs().max())))
        assert (out[~live] == 0).all()
        assert torch.equal(out.view(torch.int32), full[r0:r1].view(torch.int32))
    assert float(full.abs().sum()) > 0


@pytest.mark.parametrize("overflow", [False, True], ids=["seams", "overflow"])
@pytest.mark.parametrize("widths", [(2,), (2, 1, 1)], ids=["d2", "d4"])
@pytest.mark.parametrize("p", [6, 40, smr.STAGED_MAX_P + 8], ids=["p6", "p40", "p_direct"])
def test_sm_rebucket_halo_kernel_bit_equal(device, p, widths, overflow):
    """K4's halo form through the parts entry on row bands of a ragged grid
    (slots moved up to a row across each seam, or crowded into cells), the
    last band the whole grid with dead halo rows (a one-shard mesh): one
    launch counted under sm_rebucket_halo, bit-equal to its twin, and the
    bands' outputs are the one-device kernel's rows with the same total
    drops; the staged route (P = 6, P = 40) and the one-thread-per-cell
    route (P beyond the staged limit)."""
    ny = 23 if p <= 40 else 6
    bands = SLOT_BANDS if p <= 40 else ((0, 3), (3, 6), (0, 6))
    grid, pos, mask, vals = _k4_case(device, p, ny, 37 if p <= 40 else 7, 0.7, seed=40 + p,
                                     full=overflow)
    h = grid.cell_size
    gen = torch.Generator().manual_seed(p)
    step = torch.randint(-1, 2, pos.shape[:-1], generator=gen).to(device)
    adv = pos.clone()
    adv[..., 1] += step * h * 0.9
    adv[..., 0] += (torch.rand(pos.shape[:-1], generator=gen).to(device) - 0.5) * 0.3 * h
    if overflow:
        adv[..., 0] += 0.6 * h  # crowds cells
    parts, k = [], 0
    for c in widths:
        parts.append(vals[..., k].contiguous() if c == 1 else vals[..., k:k + c].contiguous())
        k += c
    full = smr.sm_rebucket_parts(adv, mask, tuple(parts), grid)
    drops, crossed = 0, 0
    for r0, r1 in bands:
        halo = Halo(tuple(_slot_halo(t, r0, r1) for t in (mask, adv, *parts)), r0, ny)
        args = (adv[r0:r1].contiguous(), mask[r0:r1].contiguous(),
                tuple(t[r0:r1].contiguous() for t in parts),
                dataclasses.replace(grid, ny=r1 - r0))
        before = smr.LAUNCHES["sm_rebucket_halo"]
        out = smr.sm_rebucket_parts(*args, halo=halo)
        assert smr.LAUNCHES["sm_rebucket_halo"] == before + 1
        ref = smr.sm_rebucket_ref(args[0], args[1], vals[r0:r1, :, :, :k].contiguous(), args[3],
                                  halo._replace(planes=(*halo.planes[:2], _slot_halo(
                                      vals[..., :k].contiguous(), r0, r1))))
        torch.cuda.synchronize()
        stacked = torch.cat([v[..., None] if v.ndim == 3 else v for v in out[2]], dim=-1)
        got = _bits((out[0], out[1], stacked, out[3]))
        for what, a, b in zip(("positions", "mask", "payload", "drops"), got, _bits(ref)):
            assert torch.equal(a, b), f"{what} [{r0}, {r1})"
        for a, b in zip((out[0], out[1], *out[2]), (full[0], full[1], *full[2])):
            assert torch.equal(_bits((a,))[0], _bits((b[r0:r1],))[0])
        if (r0, r1) != (0, ny):
            drops += int(out[3])
            crossed += abs(int(out[1].sum()) - int(args[1].sum()))
    assert drops == int(full[3])
    assert crossed > 0
    if overflow:
        assert drops > 0


def _sharded_padded_rank(group, kind, steps, kick):
    """One gloo rank of test_sharded_padded_steps_equal_one_device: the 3k
    double dam-break, fluid kicked upward by `kick` m/s, `steps` sharded
    steps of the padded driver; (per-step counts, gathered live rows, the
    launches of the run)."""
    from yasph2d_tpu_torch.parallel.shard_dense import ShardedDFSPHPadded, ShardedWCSPHPadded

    world = double_dam_break(3_000)
    solver, boundary = bench_solver(kind, world, device=group.device, ny_multiple=group.size)
    cls = ShardedDFSPHPadded if kind.startswith("dfsph") else ShardedWCSPHPadded
    sharded = cls(group, viscosity_model=solver.viscosity_model,
                  properties=solver.properties, full_grid=solver.grid,
                  step_config=solver.step_config)
    state = world.initial_state(device=group.device)
    state = state._replace(velocities=state.velocities + torch.tensor(
        [0.0, kick], device=group.device))
    carry, b = sharded.init(state, boundary)
    tpp.reset_launch_counts()
    smr.reset_launch_counts()
    counts = []
    for _ in range(steps):
        carry, d = sharded.simulate(carry, b, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    launches = {k: v for k, v in {**tpp.LAUNCHES, **smr.LAUNCHES}.items() if v}
    return counts, sharded.gather_live_rows(carry).cpu(), launches


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "wcsph_padded_k5"])
def test_sharded_padded_steps_equal_one_device(device, kind):
    """Two gloo ranks sharing the card: 40 steps of the 3k double dam-break
    kicked 3 m/s upward give the one-device padded solver's per-step
    iterations and drops and its live rows bit for bit, through K5's and
    K4's halo launchers only."""
    from yasph2d_tpu_torch.parallel import comm

    steps, kick = 40, 3.0
    world = double_dam_break(3_000)
    solver, boundary = bench_solver(kind, world, device=device, ny_multiple=2)
    state = world.initial_state(device=device)
    state = state._replace(velocities=state.velocities + torch.tensor([0.0, kick],
                                                                        device=device))
    carry = solver.init_carry(state, boundary)
    counts = []
    for _ in range(steps):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive].cpu()
    results = comm.spawn(_sharded_padded_rank, 2, "gloo", [device, device], kind, steps, kick)
    for got_counts, got_rows, launches in results:
        assert got_counts == counts
        assert torch.equal(got_rows.view(torch.int32), rows.view(torch.int32))
        assert launches and all(k.endswith("_halo") for k in launches)
        assert "sm_rebucket_halo" in launches


def _recorded_app(kind, device, directory, frames, first):
    """SimulationApp on the reference scene at 1600 particles/m^2, recording
    `frames` frames at 160x120; the steps of each frame, the frames, and
    (dt, live rows) after each of the first `first` steps."""
    from yasph2d_tpu_torch.app import SimulationApp, UpdateMode, default_world

    app = SimulationApp(solver=kind, world=default_world(1600.0), resolution=(160, 120),
                        update_mode=UpdateMode.RECORDING, recording_dir=str(directory),
                        device=device)
    states, step = [], app.single_sim_step

    def single_sim_step():
        step()
        if len(states) < first:
            states.append((app.time_manager.simulation_step, app.particle_state()))

    app.single_sim_step = single_sim_step
    steps, images = [], []
    for _ in range(frames):
        app.update()
        steps.append(app.time_manager.num_simulation_steps_this_frame)
        images.append(app.draw())
    assert app.recorder.flush() == 0
    return app, steps, images, states


@pytest.mark.parametrize("kind", ["dfsph_padded", "dfsph_plane"])
def test_app_records_on_the_card(device, kind, tmp_path):
    """SimulationApp records 2 frames of the reference scene at 1600
    particles/m^2 on the card (K5 + K4, K1 + K2), against the same app on the
    CPU at the CPU tests' tolerances (tests/test_torch_app.py: the scene
    ejects a particle at 100-200 m/s on the first step and turns chaotic): the
    first 30 steps' dt to 1e-6 relative and live positions to 1e-5 (matched
    to the nearest CPU particle, one to one), equal steps per frame, no
    warning, every particle live, the centre of mass within a tenth of the
    particle spacing, and each frame within 1% of pixels."""
    from yasph2d_tpu_torch.ops import pair_reduce, pallas_pair

    first = 30
    mod = pair_reduce if kind.endswith("plane") else pallas_pair
    mod.reset_launch_counts()
    gpu = _recorded_app(kind, device, tmp_path / "gpu", 2, first)
    assert sum(mod.LAUNCHES.values()) > 0
    cpu = _recorded_app(kind, "cpu", tmp_path / "cpu", 2, first)
    (g_app, g_steps, g_images, g_states), (c_app, c_steps, c_images, c_states) = gpu, cpu
    assert g_steps == c_steps and list(g_app.warnings) == list(c_app.warnings) == []
    for (gdt, (gp, _)), (cdt, (cp, _)) in zip(g_states, c_states):
        assert abs(gdt - cdt) <= 1e-6 * cdt
        assert gp.shape == cp.shape
        dist = np.sqrt(((gp[:, None, :] - cp[None, :, :]) ** 2).sum(-1))
        idx = dist.argmin(1)
        assert len(np.unique(idx)) == len(idx) and dist.min(1).max() <= 1e-5
    (gp, gv), (cp, cv) = g_app.particle_state(), c_app.particle_state()
    n = g_app.world.num_dynamic_particles
    assert gp.shape == cp.shape == (n, 2) and np.isfinite(gp).all() and np.isfinite(gv).all()
    np.testing.assert_allclose(gp.mean(0), cp.mean(0), rtol=0, atol=0.1 / np.sqrt(1600.0))
    for a, b in zip(g_images, c_images):
        assert (a != b).any(axis=-1).mean() < 0.01
    assert sorted(p.name for p in (tmp_path / "gpu").iterdir()) == ["0.png", "1.png"]
