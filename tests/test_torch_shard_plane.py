"""The sharded plane solvers of the port (yasph2d_tpu_torch/parallel/) on the
CPU: gloo ranks started by `parallel.comm.spawn` (once per rank count for the
whole module), the kernels' plain twins.

- K1's and K2's halo forms (their twins) against the JAX package's sharded
  pf_pair_reduce and pf_rebucket under shard_map on the conftest's 8-device
  CPU mesh (interpret mode, as tests/test_shard_plane.py runs them): K1 on
  live slots to the cancellation tolerance of tests/test_torch_pair_reduce.py
  (rtol 1e-5, atol 1e-6 of the plane's scale), K2 bit for bit, migration
  across every seam included.
- The halo twins band by band against the one-device twins on the whole
  grid: bit for bit.
- `SpaceGroup.halo_rows`, `sum`, `max` and `all_gather` at 2 and 4 ranks
  against the same computation in one process.
- ShardedDFSPHPlane and ShardedWCSPHPlane, f32 and bf16, at 2 and 4 ranks,
  on a contact scene with seeded 3 m/s velocities, so that particles cross
  the seams: per-step iterations and drops equal to the port's one-device
  solver on the same grid and live rows bit for bit; against the JAX
  one-device solver equal counts and live rows to the tolerances of
  tests/test_torch_dfsph_plane.py (DFSPH, rtol 1e-5 atol 1e-6; bf16 atol
  1e-5 as tests/test_torch_pf_bf16.py) and tests/test_torch_wcsph.py
  (WCSPH, positions atol 1e-5, densities rtol 1e-5 atol 1e-3).
- slow: one step of the port's sharded DFSPH against JAX's own
  ShardedDFSPHPlane.step_fn() on the scene of tests/test_shard_plane.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from yasph2d_tpu.models.dfsph_plane import DFSPHPlaneSolver as JSolver
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_plane import WCSPHPlaneSolver as JWSolver
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.pallas_slotmajor import (
    _nx_padded,
    pass_flags,
    pf_build_geom,
    pf_pair_reduce,
    pf_rebucket,
)
from yasph2d_tpu.timemanager import AdaptiveTimeStep as JAdaptive
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_plane import WCSPHPlaneSolver as TWSolver
from yasph2d_tpu_torch.ops import pair_reduce as tpr
from yasph2d_tpu_torch.ops import rebucket as trb
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.planes import Halo, plane_geom
from yasph2d_tpu_torch.parallel import comm
from yasph2d_tpu_torch.parallel.shard_dense import distribute, make_local_grid
from yasph2d_tpu_torch.parallel.shard_plane import (
    ShardedDFSPHPlane,
    ShardedWCSPHPlane,
    make_local_plane_grid,
)
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

N_SHARDS = 8  # the JAX mesh
AXIS = "space"
RTOL, ATOL = 1e-5, 1e-6
RANKS = (2, 4)
STEPS = 4
# the solver scenarios: (DFSPH or WCSPH, pair dtype)
KINDS = (("dfsph", "float32"), ("dfsph", "bfloat16"), ("wcsph", "float32"),
         ("wcsph", "bfloat16"))


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_SHARDS:
        pytest.skip("needs 8 devices")
    return jax.sharding.Mesh(np.asarray(jax.devices()[:N_SHARDS]), (AXIS,))


# ------------------------------------------------------------ rows and bands

def band(t, r0, r1):
    return t[..., r0:r1, :].contiguous()


def halo_rows(t, r0, r1):
    """Rows r0 - 1 and r1 of (..., ny, nx) planes as (..., 2, nx): what a shard
    of rows [r0, r1) receives; zero (dead) off the grid."""
    ny = t.shape[-2]
    rows = [t[..., r:r + 1, :] if 0 <= r < ny else torch.zeros_like(t[..., :1, :])
            for r in (r0 - 1, r1)]
    return torch.cat(rows, dim=-2).contiguous()


def band_geom(g, r0, r1):
    """Rows [r0, r1) of a geometry, with rows r0 - 1 and r1 as its halo."""
    return g._replace(pos=band(g.pos, r0, r1), mask=band(g.mask, r0, r1),
                      halo=Halo((halo_rows(g.pos, r0, r1), halo_rows(g.mask, r0, r1)),
                                r0, g.mask.shape[-2]))


def bands(ny, n):
    return [(k * ny // n, (k + 1) * ny // n) for k in range(n)]


# --------------------------------------- K1 / K2 halo forms against JAX shard_map

NY, NX, P = 16, 8, 3  # tests/test_shard_plane.py's grid: 2 rows a shard


def jax_terms(dx, dy, r_sq, r, scalars, q, s):
    w = jnp.maximum(1.0 - r_sq, 0.0)
    return (w, (w * dx) * s[0], (w * dy) * (q[0] - s[0]))


def torch_terms(dx, dy, r_sq, r, scalars, q, s):
    w = torch.clamp(1.0 - r_sq, min=0.0)
    return (w, (w * dx) * s[0], (w * dy) * (q[0] - s[0]))


def random_planes(rng, fill=0.5):
    """tests/test_shard_plane.py's planes: each live slot inside its own unit
    cell, NXP = 128 lanes (the JAX layout), and a value plane."""
    nxp = _nx_padded(NX)
    mask = np.zeros((P, NY, nxp), dtype=bool)
    mask[:, :, :NX] = rng.random((P, NY, NX)) < fill
    off = rng.random((2, P, NY, nxp)).astype(np.float32)
    cx = np.arange(nxp, dtype=np.float32)[None, None, :]
    cy = np.arange(NY, dtype=np.float32)[None, :, None]
    pos = np.stack([cx + 0.99 * off[0], cy + 0.99 * off[1]], axis=0)
    pos = np.where(mask[None], pos, 0.0).astype(np.float32)
    vals = (rng.normal(size=(P, NY, nxp)) * mask).astype(np.float32)
    return pos, mask, vals


def jax_grids(pair_dtype):
    full = JGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P,
                 use_pallas_slotmajor=True, pallas_sm_row_block=2, pair_dtype=pair_dtype)
    return full, dataclasses.replace(full, ny=NY // N_SHARDS, halo_axis=(AXIS, N_SHARDS))


@pytest.mark.parametrize("pair_dtype", ["float32", "bfloat16"])
def test_k1_halo_twin_matches_jax_sharded(mesh, pair_dtype):
    """Each of 8 shards: the port's halo-form twin on its rows, its geometry
    built on its own rows (row0) and the neighbours' rows as its halo,
    against JAX's pf_pair_reduce under shard_map with _pf_halo exchanges."""
    full, local = jax_grids(pair_dtype)
    br = full.pallas_sm_row_block
    pos, mask, vals = random_planes(np.random.default_rng(0))

    def body(pos, mask, vals):
        g = pf_build_geom(pos, mask, br, grid=local)
        return pf_pair_reduce(jax_terms, 3, g, g, pass_flags(g, g, local), local, br,
                              q_vals=(vals,), s_vals=(vals,), interpret=True)

    ref = np.asarray(shard_map(
        body, mesh=mesh, in_specs=(JP(None, None, AXIS), JP(None, AXIS), JP(None, AXIS)),
        out_specs=JP(None, None, AXIS), check_vma=False,
    )(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(vals)))[..., :NX]

    tgrid = TGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY // N_SHARDS, occupancy=P,
                  use_pallas_slotmajor=True, pair_dtype=pair_dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., :NX]))  # noqa: E731
    pos_t, mask_t, vals_t = t(pos), t(mask), t(vals)
    geoms = [plane_geom(band(pos_t, r0, r1), band(mask_t, r0, r1), tgrid, r0)
             for r0, r1 in bands(NY, N_SHARDS)]
    def received(k, row, plane):  # a neighbour's built row, dead off the mesh
        if 0 <= k < N_SHARDS:
            t = getattr(geoms[k], plane)
            return t[..., row:row + 1 if row >= 0 else None, :]
        return torch.zeros_like(getattr(geoms[0], plane)[..., :1, :])

    outs = []
    for k, (r0, r1) in enumerate(bands(NY, N_SHARDS)):
        halo = Halo(tuple(torch.cat([received(k - 1, -1, f), received(k + 1, 0, f)], dim=-2)
                          for f in ("pos", "mask")), r0, NY)
        s = geoms[k]._replace(halo=halo)
        v = band(vals_t, r0, r1)
        outs.append(tpr.pair_reduce_ref(torch_terms, 3, geoms[k], s, 1.0, q_vals=(v,),
                                        s_vals=(v,), s_halo=(halo_rows(vals_t, r0, r1),)))
    got = torch.cat(outs, dim=2).numpy()
    live = np.broadcast_to(mask[..., :NX], got.shape)
    assert float(np.abs(ref[live]).sum()) > 0
    for c in range(3):
        atol = ATOL * max(1.0, float(np.abs(ref[c][live[c]]).max()))
        np.testing.assert_allclose(got[c][live[c]], ref[c][live[c]], rtol=RTOL, atol=atol,
                                   err_msg=f"component {c}")
    assert (got[~live] == 0).all()


def test_k2_halo_twin_matches_jax_sharded_migration(mesh):
    """tests/test_shard_plane.py's migration case (a third of the live
    particles pushed one row up or down, across seams): each shard's K2
    halo-form twin equals JAX's pf_rebucket under shard_map bit for bit, and
    no particle is lost."""
    full, local = jax_grids("float32")
    br = full.pallas_sm_row_block
    rng = np.random.default_rng(1)
    pos, mask, _ = random_planes(rng, fill=0.15)
    shift = rng.integers(-1, 2, size=mask.shape).astype(np.float32)
    pos[1] += shift * mask
    pos = np.clip(pos, 0.0, None)
    pos[1] = np.minimum(pos[1], float(NY) - 1e-3)
    pos = np.where(mask[None], pos, 0.0).astype(np.float32)
    vals = (rng.normal(size=(2, P, NY, pos.shape[3])) * mask).astype(np.float32)

    def body(pos, mask, vals):
        row0 = jax.lax.axis_index(AXIS).astype(jnp.int32) * local.ny
        return pf_rebucket(pos, mask, vals, local, br, interpret=True, row0=row0)

    ref = shard_map(
        body, mesh=mesh,
        in_specs=(JP(None, None, AXIS), JP(None, AXIS), JP(None, None, AXIS)),
        out_specs=(JP(None, None, AXIS), JP(None, AXIS), JP(None, None, AXIS), JP()),
        check_vma=False,
    )(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(vals))
    ref = [np.asarray(a)[..., :NX] for a in ref[:3]]

    tgrid = TGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY // N_SHARDS, occupancy=P)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., :NX]))  # noqa: E731
    pos_t, mask_t, vals_t = t(pos), t(mask), t(vals)
    outs, drops, crossed = [], 0, 0
    for r0, r1 in bands(NY, N_SHARDS):
        halo = Halo((halo_rows(mask_t, r0, r1), halo_rows(pos_t, r0, r1),
                     halo_rows(vals_t, r0, r1)), r0, NY)
        out = trb.rebucket_ref(band(pos_t, r0, r1), band(mask_t, r0, r1),
                               band(vals_t, r0, r1), tgrid, halo)
        outs.append(out)
        drops += int(out[3])
        crossed += abs(int(out[1].sum()) - int(band(mask_t, r0, r1).sum()))
    assert drops == 0 and crossed > 0
    for i, name in enumerate(("positions", "mask", "values")):
        got = torch.cat([o[i] for o in outs], dim=-2).numpy()
        np.testing.assert_array_equal(got, ref[i], err_msg=name)
    assert int(torch.cat([o[1] for o in outs], dim=-2).sum()) == int(mask.sum())


# --------------------------------------- halo twins against one-device twins

def port_case(seed, pair_dtype):
    """The DFSPH plane solver and random planes on a 12 x 9 grid, P 3."""
    world = TWorld(1.0, 60.0, 100.0)
    h = world.properties.smoothing_length
    grid = TGrid(cell_size=h, origin=(0.0, 0.0), nx=9, ny=12, occupancy=3,
                 use_pallas_slotmajor=True, pair_dtype=pair_dtype)
    solver = TSolver(viscosity_model=TXSPH(h), properties=world.properties, grid=grid,
                     step_config=TFixed(1.0 / 3000.0))
    rng = np.random.default_rng(seed)
    mask = torch.from_numpy(rng.random((3, 12, 9)) < 0.6)
    iy, ix = np.meshgrid(np.arange(12), np.arange(9), indexing="ij")
    pos = np.stack([ix, iy])[:, None] * h + (rng.random((2, 3, 12, 9)) * 1.1 - 0.05) * h
    pos = torch.from_numpy(np.where(mask.numpy()[None], pos, 0.0).astype(np.float32))
    v = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 12, 9)).astype(np.float32))
    return solver, grid, pos, mask, v


@pytest.mark.parametrize("pair_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["ctx_post", "visc_gravity", "corr_v"])
def test_k1_halo_twin_bands_equal_one_device(form, pair_dtype):
    """Three row bands (dead halo rows at the ends): the halo-form twin's
    output is the one-device twin's rows of the whole grid, bit for bit."""
    solver, grid, pos, mask, v = port_case(3, pair_dtype)
    geom = plane_geom(pos, mask, grid)
    rho = 100.0 + 10.0 * v[0].abs()
    f = solver._forms
    kw = {"ctx_post": dict(post_planes=(v[0][None].expand(5, -1, -1, -1).contiguous(),)),
          "visc_gravity": dict(q_vals=(v,), s_vals=(v, rho), scalars=(1.0 / 2700.0,)),
          "corr_v": dict(q_vals=(v[0],), s_vals=(v[0],), scalars=(1234.5,),
                         post_planes=(v, v[1], v))}[form]
    pform = getattr(f, form)

    def run(q, s, **k):
        return tpr.pair_reduce_ref(pform.term_fn, pform.n_out, q, s, grid.radius_sq,
                                   post_fn=pform.post_fn, n_acc=pform.n_acc, **k)

    full = run(geom, geom, **kw)
    for r0, r1 in bands(12, 3):
        k = {key: tuple(band(t, r0, r1) for t in val) if key != "scalars" else val
             for key, val in kw.items()}
        k["s_halo"] = tuple(halo_rows(t, r0, r1) for t in kw.get("s_vals", ()))
        out = run(band_geom(geom, r0, r1)._replace(halo=None), band_geom(geom, r0, r1), **k)
        assert torch.equal(out.view(torch.int32), band(full, r0, r1).view(torch.int32))
    assert float(full.abs().sum()) > 0


def test_k2_halo_twin_bands_equal_one_device():
    """Three row bands, slots moved up to a row and a column: the bands'
    halo-form re-buckets are the one-device re-bucket's rows, bit for bit,
    with the same drops."""
    solver, grid, pos, mask, v = port_case(4, "float32")
    step = torch.from_numpy(np.random.default_rng(5).integers(-1, 2, (2, 3, 12, 9)))
    pos = pos + step.float() * grid.cell_size * mask
    full = trb.rebucket_ref(pos, mask, v, grid)
    drops = 0
    for r0, r1 in bands(12, 3):
        halo = Halo((halo_rows(mask, r0, r1), halo_rows(pos, r0, r1), halo_rows(v, r0, r1)),
                    r0, 12)
        out = trb.rebucket_ref(band(pos, r0, r1), band(mask, r0, r1), band(v, r0, r1),
                               dataclasses.replace(grid, ny=r1 - r0), halo)
        for a, b in zip(out[:3], full[:3]):
            assert torch.equal(a, band(b, r0, r1))
        drops += int(out[3])
    assert drops == int(full[3])


def test_local_grids_and_distribute():
    """make_local_grid splits the rows (and refuses a count that does not
    divide them, and the plane grids a grid off the slot-major route);
    distribute puts each live particle on the shard owning its
    f32 cell row, in input order."""
    world = TWorld(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    grid = dataclasses.replace(world.dense_grid(ny_multiple=4), use_pallas_slotmajor=True)
    assert make_local_plane_grid(grid, 4).ny * 4 == grid.ny
    with pytest.raises(ValueError, match="must divide"):
        make_local_grid(dataclasses.replace(grid, ny=grid.ny + 1), 4)
    with pytest.raises(ValueError, match="use_pallas_slotmajor"):
        make_local_plane_grid(dataclasses.replace(grid, use_pallas_slotmajor=False), 2)
    state = world.initial_state(device="cpu")
    blocks = distribute(state, grid, 4)
    assert sum(b.positions.shape[0] for b in blocks) == world.num_dynamic_particles
    ny_l = grid.ny // 4
    for k, b in enumerate(blocks):
        rows = torch.floor((b.positions[:, 1] - np.float32(grid.origin[1]))
                           * np.float32(1.0 / grid.cell_size)).long()
        assert bool(((rows // ny_l) == k).all())


# --------------------------------------------------------- spawned gloo ranks

def contact_scene(world_cls):
    """tests/test_torch_dfsph_plane.py's contact scene: 90 fluid particles on a
    floor against a wall."""
    world = world_cls(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def noise(n):
    return np.random.default_rng(42).normal(0.0, 3.0, (n, 2)).astype(np.float32)


def port_setup(kind, pair_dtype):
    """(world, full grid, initial state with the seeded velocities, solver
    keywords) of a scenario, on a grid whose rows divide over 2 and 4 ranks."""
    world = contact_scene(TWorld)
    grid = dataclasses.replace(world.dense_grid(ny_multiple=4), use_pallas_slotmajor=True,
                               pair_dtype=pair_dtype)
    state = world.initial_state(device="cpu")
    state = state._replace(velocities=torch.from_numpy(noise(state.positions.shape[0])))
    h = world.properties.smoothing_length
    step = TFixed(1.0 / 250.0) if kind == "dfsph" else TAdaptive(1 / 360, 1 / 24000, 0.2)
    return world, grid, state, dict(viscosity_model=TXSPH(h), properties=world.properties,
                                    step_config=step)


def band_counts(mask_flat, grid, n):
    """Live particles in each of n row bands of a gathered export."""
    per_row = mask_flat.reshape(grid.ny, -1).sum(dim=1)
    return [int(per_row[r0:r1].sum()) for r0, r1 in bands(grid.ny, n)]


def space_checks(group):
    """SpaceGroup's collectives on this rank's band of seeded planes."""
    rng = np.random.default_rng(9)
    ny = 3 * group.size
    f32 = torch.from_numpy(rng.normal(size=(2, 3, ny, 5)).astype(np.float32))
    flags = torch.from_numpy(rng.random((3, ny, 5)) < 0.5)
    bf = torch.from_numpy(rng.normal(size=(3, ny, 5)).astype(np.float32)).to(torch.bfloat16)
    r0, r1 = 3 * group.rank, 3 * group.rank + 3
    below, above = group.halo_rows([band(f32, r0, r1), band(flags, r0, r1), band(bf, r0, r1)])
    x = torch.tensor(0.5 * (group.rank + 1), dtype=torch.float32)
    # the rows are views of one received buffer: saved apart, as clones
    return dict(below=[t.clone() for t in below], above=[t.clone() for t in above],
                sum=group.sum(x), max=group.max(-x),
                count=group.sum(torch.tensor(group.rank + 10)),
                gathered=group.all_gather(torch.full((2, 3), float(group.rank))))


def solver_run(group, kind, pair_dtype):
    world, grid, state, kw = port_setup(kind, pair_dtype)
    cls = ShardedDFSPHPlane if kind == "dfsph" else ShardedWCSPHPlane
    sharded = cls(group, full_grid=grid, **kw)
    carry, bpl = sharded.init(state, world.boundary_dense(grid, device="cpu"))
    counts, bands_per_step = [], [band_counts(sharded.export_state(carry).alive, grid,
                                              group.size)]
    for _ in range(STEPS):
        carry, d = sharded.simulate(carry, bpl, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
        bands_per_step.append(band_counts(sharded.export_state(carry).alive, grid, group.size))
    return dict(counts=counts, rows=sharded.gather_live_rows(carry), bands=bands_per_step,
                kinds=(type(sharded.solver).__name__, sharded.solver.grid.ny))


def rank_main(group):
    """Everything this module asks of one gloo rank."""
    return dict(space=space_checks(group),
                runs={k: solver_run(group, *k) for k in KINDS})


# each computed once for the module (pytest may set a parametrized module
# fixture up more than once)
@functools.lru_cache(maxsize=None)
def ranks(n):
    return comm.spawn(rank_main, n, "gloo", ["cpu"] * n)


@pytest.mark.parametrize("n", RANKS)
def test_space_group_collectives(n):
    results = ranks(n)
    rng = np.random.default_rng(9)
    ny = 3 * n
    f32 = torch.from_numpy(rng.normal(size=(2, 3, ny, 5)).astype(np.float32))
    flags = torch.from_numpy(rng.random((3, ny, 5)) < 0.5)
    bf = torch.from_numpy(rng.normal(size=(3, ny, 5)).astype(np.float32)).to(torch.bfloat16)
    for rank, res in enumerate(results):
        space = res["space"]
        r0, r1 = 3 * rank, 3 * rank + 3
        for got_b, got_a, plane in zip(space["below"], space["above"], (f32, flags, bf)):
            rows = halo_rows(plane, r0, r1)
            assert got_b.dtype == got_a.dtype == plane.dtype
            assert torch.equal(got_b, rows[..., :1, :]) and torch.equal(got_a, rows[..., 1:, :])
        assert float(space["sum"]) == 0.5 * n * (n + 1) / 2
        assert float(space["max"]) == -0.5
        assert int(space["count"]) == sum(range(10, 10 + n))
        assert torch.equal(space["gathered"],
                           torch.arange(n, dtype=torch.float32).repeat_interleave(2)[:, None]
                           .expand(-1, 3))


@functools.lru_cache(maxsize=None)
def one_device(kind, pair_dtype):
    """The port's one-device solver on the sharded runs' grid: per-step counts
    and live rows (x, y, vx, vy, density in slot order)."""
    world, grid, state, kw = port_setup(kind, pair_dtype)
    solver = (TSolver if kind == "dfsph" else TWSolver)(grid=grid, **kw)
    boundary = solver.boundary_planes(world.boundary_dense(grid, device="cpu"))
    carry = solver.init_carry(state, boundary)
    counts = []
    for _ in range(STEPS):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive]
    return counts, rows


@pytest.mark.parametrize("key", KINDS, ids=["-".join(k) for k in KINDS])
@pytest.mark.parametrize("n", RANKS)
def test_sharded_solver_equals_one_device(n, key):
    """Equal per-step iterations and drops, live rows bit for bit, on every
    rank; particles crossed the seams (the live counts of the shards' bands
    changed), and the run went through the shard solver on the shard's rows."""
    results = ranks(n)
    counts, rows = one_device(*key)
    for res in results:
        run = res["runs"][key]
        assert run["counts"] == counts
        assert torch.equal(run["rows"].view(torch.int32), rows.view(torch.int32))
        assert run["kinds"][0].endswith("PlaneShardSolver")
    moved = [sum(abs(a - b) for a, b in zip(s0, s1))
             for s0, s1 in zip(results[0]["runs"][key]["bands"],
                               results[0]["runs"][key]["bands"][1:])]
    assert sum(moved) > 0, moved
    assert all(c[2] == 0 for c in counts)
    if key[0] == "dfsph":
        assert max(c[0] for c in counts) > 1 and max(c[1] for c in counts) > 1


@functools.lru_cache(maxsize=None)
def jax_reference(kind, pair_dtype):
    """The JAX one-device plane solver from the same state (jitted, its pf
    kernels in interpret mode): per-step counts and sorted live rows
    (x, y, density)."""
    world = contact_scene(JWorld)
    h = world.properties.smoothing_length
    grid = dataclasses.replace(world.dense_grid(ny_multiple=4), use_pallas_slotmajor=True,
                               pallas_sm_row_block=4, pair_dtype=pair_dtype)
    step = JFixed(1.0 / 250.0) if kind == "dfsph" else JAdaptive(1 / 360, 1 / 24000, 0.2)
    solver = (JSolver if kind == "dfsph" else JWSolver)(
        viscosity_model=JXSPH(h), properties=world.properties, grid=grid, step_config=step)
    boundary = solver.boundary_planes(world.boundary_dense(grid))
    state = world.initial_state()
    state = state._replace(velocities=jnp.asarray(noise(state.positions.shape[0])))
    carry = jax.jit(solver.init_carry)(state, boundary)
    simulate = jax.jit(solver.simulate, static_argnums=2)
    counts = []
    for _ in range(STEPS):
        carry, d = simulate(carry, boundary, 1)
        counts.append((int(d.density_iterations), int(d.divergence_iterations),
                       int(d.neighbor_drops)))
    s = solver.export_state(carry)
    alive = np.asarray(s.alive)
    rows = np.concatenate([np.asarray(s.positions), np.asarray(s.densities)[:, None]],
                          axis=1)[alive]
    return counts, rows[np.lexsort(rows.T)]


@pytest.mark.parametrize("key", KINDS, ids=["-".join(k) for k in KINDS])
@pytest.mark.parametrize("n", RANKS)
def test_sharded_solver_matches_jax(n, key):
    """Against the JAX one-device solver: equal per-step counts (iterations
    only for DFSPH, WCSPH has none), live rows to the port's solver
    tolerances."""
    kind, pair_dtype = key
    counts, ref = jax_reference(*key)
    run = ranks(n)[0]["runs"][key]
    assert run["counts"] == counts
    rows = run["rows"][:, [0, 1, 4]].numpy()
    rows = rows[np.lexsort(rows.T)]
    assert rows.shape == ref.shape
    if kind == "dfsph":
        atol = 1e-5 if pair_dtype == "bfloat16" else 1e-6
        np.testing.assert_allclose(rows, ref, rtol=1e-5, atol=atol)
    else:
        np.testing.assert_allclose(rows[:, :2], ref[:, :2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(rows[:, 2], ref[:, 2], rtol=1e-5, atol=1e-3)


def test_backend_refusals():
    """A backend that cannot serve the ranks' devices raises before any rank
    starts: nccl on the CPU, nccl with two ranks on one card, an unknown
    backend."""
    with pytest.raises(ValueError, match="CUDA"):
        comm.check_backend("nccl", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="one card per rank"):
        comm.check_backend("nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="backend must be"):
        comm.spawn(rank_main, 2, "mpi", ["cpu", "cpu"])
    comm.check_backend("gloo", ["cuda:0", "cuda:0"])


def step_rank(group, full_grid_kw):
    """One sharded DFSPH step on the scene of tests/test_shard_plane.py."""
    world = TWorld(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    grid = TGrid(**full_grid_kw)
    h = world.properties.smoothing_length
    sharded = ShardedDFSPHPlane(group, viscosity_model=TXSPH(h), properties=world.properties,
                                full_grid=grid, step_config=TFixed(1.0 / 3000.0),
                                max_density_iterations=3, max_divergence_iterations=3)
    carry, bpl = sharded.init(world.initial_state(device="cpu"),
                              world.boundary_dense(grid, device="cpu"))
    carry, d = sharded.step(carry, bpl)
    s = sharded.export_state(carry)
    return (d.density_iterations, d.divergence_iterations, d.neighbor_drops), s


@pytest.mark.slow
def test_sharded_step_matches_jax_sharded_step(mesh):
    """tests/test_shard_plane.py's full sharded step: JAX's
    ShardedDFSPHPlane.step_fn() on 8 shards (interpret-mode kernels) against
    the port's ShardedDFSPHPlane on 4 gloo ranks on the same grid: equal
    iterations and drops, equal masks, live positions and velocities to the
    solver tolerance (rtol 1e-5)."""
    from yasph2d_tpu.parallel.shard_plane import ShardedDFSPHPlane as JSharded

    world = JWorld(1.0, 60.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    jgrid = dataclasses.replace(world.dense_grid(occupancy=3, ny_multiple=N_SHARDS),
                                use_pallas_slotmajor=True, pallas_sm_row_block=4)
    h = world.properties.smoothing_length
    sharded = JSharded(viscosity_model=JXSPH(h), properties=world.properties,
                       full_grid=jgrid, step_config=JFixed(1.0 / 3000.0), mesh=mesh,
                       max_density_iterations=3, max_divergence_iterations=3)
    carry, bpl = sharded.init(world.initial_state(), world.boundary_dense(jgrid),
                              use_jit=False)
    carry, diag = sharded.step_fn()(carry, bpl)
    grid_kw = dict(cell_size=jgrid.cell_size, origin=jgrid.origin, nx=jgrid.nx, ny=jgrid.ny,
                   occupancy=3, use_pallas_slotmajor=True)
    counts, s = comm.spawn(step_rank, 4, "gloo", ["cpu"] * 4, grid_kw)[0]
    assert counts == (int(diag.density_iterations), int(diag.divergence_iterations),
                      int(diag.neighbor_drops))
    jmask = np.transpose(np.asarray(carry.ctx.mask)[:, :jgrid.ny, :jgrid.nx], (1, 2, 0))
    mask = s.alive.numpy().reshape(jmask.shape)
    np.testing.assert_array_equal(mask, jmask)
    for name, j, t in (("pos", carry.ctx.pos, s.positions), ("v", carry.v, s.velocities)):
        j = np.transpose(np.asarray(j)[:, :, :jgrid.ny, :jgrid.nx], (2, 3, 1, 0))
        np.testing.assert_allclose(t.numpy().reshape(j.shape)[mask], j[mask], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_parallel_imports_no_jax():
    """The port's parallel package imports neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "import yasph2d_tpu_torch.parallel.comm, yasph2d_tpu_torch.parallel.shard_dense\n"
        "import yasph2d_tpu_torch.parallel.shard_plane\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m.split('.')[0] == 'yasph2d_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
