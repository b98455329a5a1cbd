"""The sharded padded solvers of the port (yasph2d_tpu_torch/parallel/
shard_dense.py) on the CPU: gloo ranks started by `parallel.comm.spawn`
(once per rank count for the whole module), the kernels' plain twins.

- K5's and K4's halo forms (their twins) against the JAX package's XLA
  dense_grid.pair_reduce and dense_grid.rebucket(row0=...) under shard_map on
  the conftest's 8-device CPU mesh, which is what the JAX sharded padded
  route runs: K5 on live slots to the cancellation tolerance of
  tests/test_torch_pair_reduce.py (rtol 1e-5, atol 1e-6 of the component's
  scale), K4 bit for bit with a third of the particles moved across a seam.
- The halo twins band by band against the one-device twins on the whole
  grid: bit for bit.
- K5's bf16 math mode on the same bands: the halo twin, each band rebased
  on its global rows, equals the one-device bf16 twin's rows bit for bit.
- ShardedDFSPHPadded and ShardedWCSPHPadded at 2 and 4 ranks, on a contact
  scene with seeded 3 m/s velocities (particles cross the seams), in f32
  and on a bf16 grid (K5's bf16 math mode), with rebuild_every = 3, and on
  a column spanning every shard: per-step
  iterations and drops equal to the port's one-device solver on the same
  grid, live rows bit for bit, every particle live.
- The same drivers against JAX's ShardedDFSPHPadded and ShardedWCSPHPadded on
  the small dam-break (2 and 4 device meshes): equal iterations and drops,
  live positions within atol 5e-5 (tests/test_shard_padded.py's tolerance).
- The refusals: the slot-major route under sharding, rows that do not divide
  over the shards, halo rows that do not fit the call.
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

from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.dense_grid import pair_reduce as j_pair_reduce
from yasph2d_tpu.ops.dense_grid import rebucket as j_rebucket
from yasph2d_tpu.parallel.shard_dense import ShardedDFSPHPadded as JShardedDFSPH
from yasph2d_tpu.parallel.shard_dense import ShardedWCSPHPadded as JShardedWCSPH
from yasph2d_tpu.parallel.shard_dense import make_space_mesh
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import PhysicalViscosityModel as TPhys
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TWSolver
from yasph2d_tpu_torch.ops import pallas_pair as tpp
from yasph2d_tpu_torch.ops import sm_rebucket as tsr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.planes import Halo
from yasph2d_tpu_torch.parallel import comm
from yasph2d_tpu_torch.parallel.shard_dense import (
    DFSPHPaddedShardSolver,
    ShardedDFSPHPadded,
    ShardedWCSPHPadded,
)
from yasph2d_tpu_torch.timemanager import AdaptiveTimeStep as TAdaptive
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils import profiling
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

N_SHARDS = 8  # the JAX mesh of the kernel checks
AXIS = "space"
RTOL, ATOL = 1e-5, 1e-6
RANKS = (2, 4)
STEPS = 4
KINDS = ("dfsph", "wcsph")
DAM_DENSITY, DAM_STEPS = 400.0, 5  # the small dam-break of the JAX comparison


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N_SHARDS:
        pytest.skip("needs 8 devices")
    return jax.sharding.Mesh(np.asarray(jax.devices()[:N_SHARDS]), (AXIS,))


# ------------------------------------------------------------ rows and bands

def band(t, r0, r1):
    return t[r0:r1].contiguous()


def halo_rows(t, r0, r1):
    """Rows r0 - 1 and r1 of an (ny, nx, ...) slot tensor as (2, nx, ...): what a
    shard of rows [r0, r1) receives; zero (dead) off the grid."""
    rows = [t[r:r + 1] if 0 <= r < t.shape[0] else torch.zeros_like(t[:1])
            for r in (r0 - 1, r1)]
    return torch.cat(rows).contiguous()


def bands(ny, n):
    return [(k * ny // n, (k + 1) * ny // n) for k in range(n)]


def slot_space(rng, ny, nx, p, fill):
    """Live slots at random (not compacted), each inside its own unit cell;
    a scalar and a two-component value."""
    mask = rng.random((ny, nx, p)) < fill
    cy, cx = np.meshgrid(np.arange(ny, dtype=np.float32), np.arange(nx, dtype=np.float32),
                         indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :]
    pos = np.where(mask[..., None], cell + 0.99 * rng.random((ny, nx, p, 2)), 0.0)
    k = rng.normal(size=(ny, nx, p)) * mask
    v = rng.normal(size=(ny, nx, p, 2)) * mask[..., None]
    return [a.astype(np.float32) if a.dtype != bool else a for a in (pos, mask, k, v)]


# --------------------------------------------------------- K5 against JAX

NY, NX, P, PS = 16, 8, 3, 5  # 2 rows a shard of the JAX mesh


def jax_terms(rij, r_sq, r, qk, sk, sv):
    w = jnp.maximum(1.0 - r_sq, 0.0)
    return (w, (w * rij[..., 0]) * sk, (w * rij[..., 1]) * (qk - sk),
            w * sv[..., 0] + rij[..., 1] * sv[..., 1])


def torch_terms(dx, dy, r_sq, r, scalars, q, s):
    w = torch.clamp(1.0 - r_sq, min=0.0)
    return (w, (w * dx) * s[0], (w * dy) * (q[0] - s[0]), w * s[1] + dy * s[2])


@pytest.mark.parametrize("source", ["fluid", "boundary"])
def test_k5_halo_twin_matches_jax_sharded(mesh, source):
    """Each of 8 shards: the port's K5 halo-form twin on its rows, the
    neighbours' rows as its halo, against JAX's XLA pair_reduce under
    shard_map (halo2d_multi's ppermute pair); the source the fluid itself
    (Ps = P) or another space (Ps = 5, as a boundary)."""
    rng = np.random.default_rng(0)
    q = slot_space(rng, NY, NX, P, 0.6)
    s = q if source == "fluid" else slot_space(rng, NY, NX, PS, 0.5)
    full = JGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    local = dataclasses.replace(full, ny=NY // N_SHARDS, halo_axis=(AXIS, N_SHARDS))

    def body(qp, qm, qk, sp, sm, sk, sv):
        return j_pair_reduce(jax_terms, qp, qm, sp, sm, local, source_values=(sk, sv),
                             query_values=(qk,))

    spec = JP(AXIS)
    ref = shard_map(body, mesh=mesh, in_specs=(spec,) * 7, out_specs=(spec,) * 4,
                    check_vma=False)(*(jnp.asarray(a) for a in (q[0], q[1], q[2], s[0], s[1],
                                                                 s[2], s[3])))
    ref = np.stack([np.asarray(a) for a in ref], axis=-1)

    t = [torch.from_numpy(a) for a in (*q, *s)]
    qp, qm, qk, _, sp, sm, sk, sv = t
    outs = []
    for r0, r1 in bands(NY, N_SHARDS):
        halo = Halo(tuple(halo_rows(a, r0, r1) for a in (sp, sm, sk, sv)), r0, NY)
        outs.append(tpp.pallas_pair_reduce_ref(
            torch_terms, 4, band(qp, r0, r1), band(qm, r0, r1), band(sp, r0, r1),
            band(sm, r0, r1), full.radius_sq, q_vals=(band(qk, r0, r1),),
            s_vals=(band(sk, r0, r1), band(sv, r0, r1)), halo=halo))
    got = torch.cat(outs).numpy()
    live = q[1]
    assert float(np.abs(ref[live]).sum()) > 0
    for c in range(4):
        atol = ATOL * max(1.0, float(np.abs(ref[..., c][live]).max()))
        np.testing.assert_allclose(got[..., c][live], ref[..., c][live], rtol=RTOL, atol=atol,
                                   err_msg=f"component {c}")
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("d", [2, 4])
def test_k4_halo_twin_matches_jax_sharded_migration(mesh, d):
    """A third of the live slots pushed a row up or down (across the seams of
    the 8 shards), the rest moved within their cell's window: each shard's
    K4 halo-form twin equals JAX's XLA rebucket(row0=...) under shard_map bit
    for bit (positions, mask, payload of D = 2 and 4), with the same drops
    (cells that receive more than P), and no other particle is lost."""
    rng = np.random.default_rng(1)
    pos, mask, _, _ = slot_space(rng, NY, NX, P, 0.3)
    shift = (rng.integers(-1, 2, size=mask.shape) * (rng.random(mask.shape) < 1 / 3))
    pos[..., 1] += shift * mask
    pos[..., 0] += (rng.random(mask.shape).astype(np.float32) - 0.5) * mask
    pos = np.clip(pos, 0.0, [NX - 1e-3, NY - 1e-3]).astype(np.float32)
    pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
    vals = (rng.normal(size=(NY, NX, P, d)) * mask[..., None]).astype(np.float32)
    full = JGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY, occupancy=P)
    local = dataclasses.replace(full, ny=NY // N_SHARDS, halo_axis=(AXIS, N_SHARDS))

    def body(pos, mask, vals):
        row0 = jax.lax.axis_index(AXIS).astype(jnp.int32) * local.ny
        p, m, v, drops = j_rebucket(pos, mask, vals, local, row0=row0)
        return p, m, v, jax.lax.psum(drops, AXIS)

    spec = JP(AXIS)
    ref = shard_map(body, mesh=mesh, in_specs=(spec,) * 3,
                    out_specs=(spec, spec, spec, JP()), check_vma=False)(
        jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(vals))
    ref = [np.asarray(a) for a in ref]

    tgrid = TGrid(cell_size=1.0, origin=(0.0, 0.0), nx=NX, ny=NY // N_SHARDS, occupancy=P)
    tp, tm, tv = (torch.from_numpy(a) for a in (pos, mask, vals))
    outs, drops, crossed = [], 0, 0
    for r0, r1 in bands(NY, N_SHARDS):
        halo = Halo((halo_rows(tm, r0, r1), halo_rows(tp, r0, r1), halo_rows(tv, r0, r1)),
                    r0, NY)
        out = tsr.sm_rebucket_ref(band(tp, r0, r1), band(tm, r0, r1), band(tv, r0, r1),
                                  tgrid, halo)
        outs.append(out)
        drops += int(out[3])
        crossed += abs(int(out[1].sum()) - int(band(tm, r0, r1).sum()))
    assert drops == int(ref[3]) and crossed > 0
    for i, name in enumerate(("positions", "mask", "values")):
        got = torch.cat([o[i] for o in outs]).numpy()
        np.testing.assert_array_equal(got, ref[i], err_msg=name)
    assert int(torch.cat([o[1] for o in outs]).sum()) == int(mask.sum()) - drops


# --------------------------------------- halo twins against one-device twins

def port_case(seed, pair_dtype="float32"):
    """The DFSPH and WCSPH padded solvers on a 12 x 9 grid, P 3, with random
    live slots near their cells (a tenth of a cell outside, so pairs cross
    cells), velocities, kappa and densities."""
    world = TWorld(1.0, 60.0, 100.0)
    h = world.properties.smoothing_length
    grid = TGrid(cell_size=h, origin=(0.0, 0.0), nx=9, ny=12, occupancy=3,
                 pair_dtype=pair_dtype)
    kw = dict(viscosity_model=TXSPH(h), properties=world.properties, grid=grid)
    dfsph = TSolver(**kw, step_config=TFixed(1.0 / 3000.0))
    wcsph = TWSolver(**kw, step_config=TAdaptive(1 / 360, 1 / 24000, 0.2))
    rng = np.random.default_rng(seed)
    mask = rng.random((12, 9, 3)) < 0.6
    iy, ix = np.meshgrid(np.arange(12), np.arange(9), indexing="ij")
    pos = np.stack([ix, iy], -1)[:, :, None] * h + (rng.random((12, 9, 3, 2)) * 1.1 - 0.05) * h
    pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    vals = dict(v=t(rng.uniform(-1, 1, (12, 9, 3, 2))), k=t(rng.normal(size=(12, 9, 3))),
                rho=t(100 + 10 * rng.random((12, 9, 3))),
                pres=t(500 * rng.random((12, 9, 3))))
    return dfsph, wcsph, grid, torch.from_numpy(pos), torch.from_numpy(mask), vals


def k5_call(dfsph, wcsph, form, vals, phys=False):
    """(form, consts, keyword operands) of a padded step's K5 call."""
    if phys:
        h = dfsph.grid.cell_size
        dfsph, wcsph = (dataclasses.replace(s, viscosity_model=TPhys(h, 0.01))
                        for s in (dfsph, wcsph))
    f, w = dfsph._forms, wcsph._forms
    v, dt = vals["v"], (1.0 / 2700.0,)
    wv = (vals["pres"], vals["rho"], v)
    return {
        "dfsph_ctx": (f.ctx, dfsph._consts, {}),
        "dfsph_div": (f.div, dfsph._consts, dict(q_vals=(v,), s_vals=(v,))),
        "dfsph_corr": (f.corr, dfsph._consts, dict(q_vals=(vals["k"],), s_vals=(vals["k"],))),
        "dfsph_visc": (f.visc, dfsph._consts, dict(q_vals=(v,), s_vals=(v, vals["rho"]),
                                                   scalars=dt)),
        "wcsph_density": (w.density, wcsph._consts, {}),
        "wcsph_stat": (w.stat, wcsph._consts, {}),
        "wcsph_forces": (w.forces, wcsph._consts, dict(q_vals=wv, s_vals=wv, scalars=dt)),
    }[form]


K5_FORMS = ("dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc", "wcsph_density",
            "wcsph_stat", "wcsph_forces", "dfsph_visc_phys", "wcsph_forces_phys")


def check_k5_bands(form, pair_dtype):
    """`form` on three row bands (dead halo rows at the ends): the halo-form
    twin's output is the one-device twin's rows of the whole grid, bit for
    bit (in bf16 each band rebased on its global rows), and the CPU route
    counts no launch."""
    dfsph, wcsph, grid, pos, mask, vals = port_case(3, pair_dtype)
    pform, consts, kw = k5_call(dfsph, wcsph, form.removesuffix("_phys"), vals,
                                form.endswith("_phys"))
    assert pform.name == form
    full = tpp.pallas_pair_reduce(pform, pos, mask, pos, mask, consts,
                                  rebase=tpp.rebase_of(grid), **kw)
    before = dict(tpp.LAUNCHES)
    for r0, r1 in bands(12, 3):
        kb = {k: tuple(band(t, r0, r1) for t in kw[k]) for k in ("q_vals", "s_vals") if k in kw}
        rows = tuple(halo_rows(t, r0, r1) for t in (pos, mask, *kw.get("s_vals", ())))
        bp, bm = band(pos, r0, r1), band(mask, r0, r1)
        out = tpp.pallas_pair_reduce(pform, bp, bm, bp, bm, consts, scalars=kw.get("scalars", ()),
                                     halo=Halo(rows, r0, 12), rebase=tpp.rebase_of(grid, r0),
                                     **kb)
        assert torch.equal(out.view(torch.int32), band(full, r0, r1).view(torch.int32))
    assert tpp.LAUNCHES == before
    assert float(full.abs().sum()) > 0
    return full


@pytest.mark.parametrize("form", K5_FORMS)
def test_k5_halo_twin_bands_equal_one_device(form):
    """Every K5 form of the padded steps on three row bands (`check_k5_bands`)."""
    check_k5_bands(form, "float32")


@pytest.mark.parametrize("form", K5_FORMS)
def test_k5_bf16_halo_twin_bands_equal_one_device(form):
    """Every K5 form in its bf16 math mode on three row bands
    (`check_k5_bands`); the mode is live (its sums are not the f32 ones)."""
    bf16 = check_k5_bands(form, "bfloat16")
    assert not torch.equal(bf16, check_k5_bands(form, "float32"))


@pytest.mark.parametrize("label", ["seams", "overflow"])
def test_k4_halo_twin_bands_equal_one_device(label):
    """Three row bands, slots moved up to a row and a column (crossing the
    seams), or crowded into every other column (forced overflow): the bands'
    halo-form re-buckets through the parts entry (DFSPH payload v, kappa,
    stiffness) are the one-device re-bucket's rows, bit for bit, with the
    same total drops."""
    _, _, grid, pos, mask, vals = port_case(4)
    h = grid.cell_size
    if label == "seams":
        step = torch.from_numpy(np.random.default_rng(5).integers(-1, 2, (12, 9, 3, 2)))
        pos = pos + step.float() * h * mask[..., None]
    else:
        pos = pos.clone()
        pos[..., 0] -= (torch.arange(9) % 2 == 1).float()[None, :, None] * h
    parts = (vals["v"], vals["k"], vals["rho"])
    full = tsr.sm_rebucket_parts(pos, mask, parts, grid)
    drops = 0
    for r0, r1 in bands(12, 3):
        halo = Halo(tuple(halo_rows(t, r0, r1) for t in (mask, pos, *parts)), r0, 12)
        out = tsr.sm_rebucket_parts(band(pos, r0, r1), band(mask, r0, r1),
                                    tuple(band(t, r0, r1) for t in parts),
                                    dataclasses.replace(grid, ny=r1 - r0), halo=halo)
        for a, b in zip((out[0], out[1], *out[2]), (full[0], full[1], *full[2])):
            assert torch.equal(a, band(b, r0, r1))
        drops += int(out[3])
    assert drops == int(full[3])
    if label == "overflow":
        assert drops > 0


def test_halo_operand_checks():
    """K5's halo operands: one row pair per source value, each in its grid
    value's layout, else a ValueError (the CUDA route checks them before a
    launch; the rows need no shared memory of their own, so the launch shape
    is the one-device form's); K4's: one row pair per payload part."""
    _, _, grid, pos, mask, vals = port_case(3)
    v, rows = vals["v"], lambda t: halo_rows(t, 0, 4)  # noqa: E731
    cpu = torch.device("cpu")
    h_rows = (rows(pos), rows(mask), rows(v))
    ptrs = tpp.halo_operands(Halo(h_rows, 0, 12), (band(v, 0, 4),), cpu, 9, 3)
    assert ptrs[:2] == (h_rows[0].data_ptr(), h_rows[1].data_ptr())
    assert ptrs[2] == [h_rows[2].data_ptr(), h_rows[2].data_ptr() + 4]  # x, y; stride 2
    with pytest.raises(ValueError, match="halo value rows"):
        tpp.halo_operands(Halo((rows(pos), rows(mask)), 0, 12), (v,), cpu, 9, 3)
    with pytest.raises(ValueError, match="halo value rows"):
        tpp.halo_operands(Halo((rows(pos), rows(mask), rows(vals["k"])), 0, 12), (v,),
                          cpu, 9, 3)
    with pytest.raises(ValueError, match="halo mask"):
        tpp.halo_operands(Halo((rows(pos), rows(mask)[:, :, :2]), 0, 12), (), cpu, 9, 3)
    with pytest.raises(ValueError, match="halo value rows"):
        tpp.pallas_pair_reduce_ref(torch_terms, 4, pos, mask, pos, mask, 1.0,
                                   s_vals=(vals["k"], v), halo=Halo((rows(pos), rows(mask)),
                                                                    0, 12))
    with pytest.raises(ValueError, match="halo payload parts"):
        tsr.sm_rebucket_parts(pos, mask, (v, vals["k"]), grid,
                              halo=Halo((rows(mask), rows(pos), rows(v)), 0, 12))


# --------------------------------------------------------- spawned gloo ranks

def contact_scene():
    """tests/test_torch_dfsph_plane.py's contact scene: 90 fluid particles on a
    floor against a wall."""
    world = TWorld(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def column_scene():
    """tests/test_shard_padded.py's migration-stress scene at a third of its
    density: a fluid column spanning every shard's rows in a closed tank."""
    world = TWorld(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.1, 0.35, 2.2), 0.05)
    for a, b in (((0.0, 2.6), (2.0, 2.6)), ((0.0, 0.0), (2.0, 0.0)), ((0.0, 0.0), (0.0, 2.6)),
                 ((2.0, 0.0), (2.0, 2.6)), ((-2.0, -0.5), (4.0, -0.5))):
        world.add_boundary_thick_line(a, b, 4)
    return world


def dam_scene(world_cls):
    """tests/test_wcsph.py's small_dam_break (the reference default scene,
    main.rs:177-196) at DAM_DENSITY particles a square metre."""
    world = world_cls(2.0, DAM_DENSITY, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    for a, b, t in (((0.0, 2.5), (2.0, 2.5), 4), ((0.0, 0.0), (2.0, 0.0), 4),
                    ((0.0, 0.0), (0.0, 2.5), 4), ((2.0, 0.0), (2.0, 2.5), 4),
                    ((0.0, 0.6), (1.75, 0.5), 2), ((0.0, 2.5), (2.0, 2.5), 2),
                    ((-2.0, -0.5), (4.0, -0.5), 4)):
        world.add_boundary_thick_line(a, b, t)
    return world


def noise(n, scale=3.0, drift=(0.0, 0.0)):
    return (np.random.default_rng(42).normal(0.0, scale, (n, 2))
            + np.asarray(drift)).astype(np.float32)


def setup(case):
    """(world, full grid, initial state, solver keywords) of a scenario, on a
    grid whose rows divide over 2 and 4 ranks."""
    kind, scene = case[:2]
    scene, bf16 = scene.removesuffix("_bf16"), scene.endswith("_bf16")
    world = {"contact": contact_scene, "column": column_scene,
             "dam": lambda: dam_scene(TWorld)}[scene]()
    occupancy = 12 if scene == "dam" else None
    grid = dataclasses.replace(world.dense_grid(occupancy=occupancy, ny_multiple=4),
                               pair_dtype="bfloat16" if bf16 else "float32")
    state = world.initial_state(device="cpu")
    n = state.positions.shape[0]
    if scene == "contact":
        state = state._replace(velocities=torch.from_numpy(noise(n)))
    elif scene == "column":
        state = state._replace(velocities=torch.from_numpy(noise(n, 1.0, (0.0, -3.0))))
    h = world.properties.smoothing_length
    if scene == "dam":
        step = TFixed(1.0 / 3000.0) if kind == "dfsph" else TFixed(1.0 / 24000.0)
    elif kind == "dfsph":
        step = TFixed(1.0 / 250.0) if scene == "contact" else TAdaptive(1 / 360, 1 / 24000,
                                                                         1.5)
    else:
        step = TAdaptive(1 / 360, 1 / 24000, 0.2)
    kw = dict(viscosity_model=TXSPH(h), properties=world.properties, step_config=step)
    if len(case) > 2:
        kw["rebuild_every"] = case[2]
    return world, grid, state, kw


# (solver, scene[, rebuild_every]) of the spawned runs, and their step counts;
# a scene `<scene>_bf16` runs on a bf16 grid (K5's bf16 math mode)
CASES = {("dfsph", "contact"): STEPS, ("wcsph", "contact"): STEPS,
         ("dfsph", "contact_bf16"): STEPS, ("wcsph", "contact_bf16"): STEPS,
         ("dfsph", "contact", 3): 7, ("dfsph", "column"): 8,
         ("dfsph", "dam"): DAM_STEPS, ("wcsph", "dam"): DAM_STEPS}


def band_counts(mask_flat, grid, n):
    """Live particles in each of n row bands of a gathered export."""
    per_row = mask_flat.reshape(grid.ny, -1).sum(dim=1)
    return [int(per_row[r0:r1].sum()) for r0, r1 in bands(grid.ny, n)]


def step_counts(d):
    return (d.density_iterations, d.divergence_iterations, d.neighbor_drops)


def blocks(case):
    """The runs' simulate calls: one step each, or one call of all the steps
    with rebuild_every (its stale blocks)."""
    return [CASES[case]] if len(case) > 2 else [1] * CASES[case]


def solver_run(group, case):
    world, grid, state, kw = setup(case)
    cls = ShardedDFSPHPadded if case[0] == "dfsph" else ShardedWCSPHPadded
    sharded = cls(group, full_grid=grid, **kw)
    carry, boundary = sharded.init(state, world.boundary_dense(grid, device="cpu"))
    counts, per_band = [], [band_counts(sharded.export_state(carry).alive, grid, group.size)]
    profiling.reset_readbacks()
    for n in blocks(case):
        carry, d = sharded.simulate(carry, boundary, n)
        counts.append(step_counts(d))
        per_band.append(band_counts(sharded.export_state(carry).alive, grid, group.size))
    ctx = carry.ctx if case[0] == "dfsph" else None
    return dict(counts=counts, rows=sharded.gather_live_rows(carry), bands=per_band,
                kinds=(type(sharded.solver).__name__, sharded.solver.grid.ny),
                halo=(boundary.halo is not None, ctx is None or ctx.halo is not None),
                readbacks=dict(profiling.READBACKS), local_sums=sharded.solver._local_sums())


def rank_main(group):
    """Everything this module asks of one gloo rank."""
    return {case: solver_run(group, case) for case in CASES}


@functools.lru_cache(maxsize=None)
def ranks(n):
    return comm.spawn(rank_main, n, "gloo", ["cpu"] * n)


@functools.lru_cache(maxsize=None)
def one_device(case):
    """The port's one-device padded solver on the sharded runs' grid: per-call
    counts and live rows (x, y, vx, vy, density in slot order)."""
    world, grid, state, kw = setup(case)
    solver = (TSolver if case[0] == "dfsph" else TWSolver)(grid=grid, **kw)
    boundary = world.boundary_dense(grid, device="cpu")
    carry = solver.init_carry(state, boundary)
    counts = []
    for n in blocks(case):
        carry, d = solver.simulate(carry, boundary, n)
        counts.append(step_counts(d))
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive]
    return counts, rows, int(state.alive.sum())


def check_equal_one_device(n, case):
    results = ranks(n)
    counts, rows, n_live = one_device(case)
    assert rows.shape[0] == n_live  # every particle live
    for res in results:
        run = res[case]
        assert run["counts"] == counts
        assert torch.equal(run["rows"].view(torch.int32), rows.view(torch.int32))
        assert run["kinds"][0].endswith("PaddedShardSolver")
        assert run["halo"] == (True, True)  # the halo forms ran
    assert all(c[2] == 0 for c in counts)
    per_band = results[0][case]["bands"]
    assert all(sum(b) == n_live for b in per_band)
    moved = [sum(abs(a - b) for a, b in zip(s0, s1)) for s0, s1 in zip(per_band, per_band[1:])]
    return moved, counts


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_solver_equals_one_device(n, kind):
    """Equal per-step iterations and drops, live rows bit for bit, on every
    rank, through the shard solver with its halos; particles crossed the
    seams (the live counts of the shards' bands changed)."""
    moved, counts = check_equal_one_device(n, (kind, "contact"))
    assert sum(moved) > 0, moved
    if kind == "dfsph":
        assert max(c[0] for c in counts) > 1 and max(c[1] for c in counts) > 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_bf16_equals_one_device(n, kind):
    """The same on a bf16 grid: K5's bf16 halo forms, each shard rebased on
    its global rows, give the one-device bf16 solver's iterations, drops and
    live rows bit for bit, with particles across the seams."""
    moved, counts = check_equal_one_device(n, (kind, "contact_bf16"))
    assert sum(moved) > 0, moved
    assert not torch.equal(one_device((kind, "contact_bf16"))[1],
                           one_device((kind, "contact"))[1])


@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_loops_test_on_the_host(n):
    """The shard solvers' residual totals are global (`_local_sums` False),
    so their pressure loops keep the host's exit test: one "mean_residual"
    read-back an iteration, no loop state read."""
    for res in ranks(n):
        for case in (c for c in CASES if c[0] == "dfsph"):
            run = res[case]
            its = sum(c[0] + c[1] for c in run["counts"])
            assert run["local_sums"] is False and its > 0
            assert run["readbacks"]["mean_residual"] == its
            assert "loop_state" not in run["readbacks"]


@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_rebuild_every(n):
    """rebuild_every = 3 under sharding: 7 steps in one simulate call (two
    blocks of a rebuilding step and two stale ones, one leftover rebuilding
    step) equal the one-device solver's, with particles across the seams."""
    moved, _ = check_equal_one_device(n, ("dfsph", "contact", 3))
    assert sum(moved) > 0


@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_migration_stress(n):
    """A fluid column spanning every shard, falling at 3 m/s, through the
    violent first steps of tests/test_shard_padded.py's scene (the JAX
    package's solver, too, throws particles at ~400 m/s there): the live count
    is conserved, no drop, the one-device solver's rows bit for bit; with 4
    shards particles cross the seams (2 shards: the contact scene's test)."""
    case = ("dfsph", "column")
    moved, _ = check_equal_one_device(n, case)
    assert all(b > 0 for b in ranks(n)[0][case]["bands"][-1])  # every shard holds fluid
    if n == 4:
        assert sum(moved) > 0, moved


@functools.lru_cache(maxsize=None)
def jax_reference(n, kind):
    """JAX's sharded padded driver (XLA route, jitted) on an n-device mesh on
    the small dam-break: per-step counts and sorted live positions."""
    world = dam_scene(JWorld)
    grid = world.dense_grid(occupancy=12, ny_multiple=4)
    h = world.properties.smoothing_length
    cls, step = ((JShardedDFSPH, JFixed(1.0 / 3000.0)) if kind == "dfsph"
                 else (JShardedWCSPH, JFixed(1.0 / 24000.0)))
    sharded = cls(viscosity_model=JXSPH(h), properties=world.properties, full_grid=grid,
                  step_config=step, mesh=make_space_mesh(jax.devices()[:n]))
    carry, boundary = sharded.init(world.initial_state(), world.boundary_dense(grid))
    counts = []
    for _ in range(DAM_STEPS):
        carry, d = sharded.simulate(carry, boundary, 1)
        counts.append((int(d.density_iterations), int(d.divergence_iterations),
                       int(d.neighbor_drops)))
    mask = np.asarray(carry.ctx.mask if kind == "dfsph" else carry.mask)
    pos = np.asarray(carry.ctx.pos_pad if kind == "dfsph" else carry.pos_pad)[mask]
    return counts, pos[np.lexsort(pos.T)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", RANKS)
def test_sharded_padded_solver_matches_jax_sharded(mesh, n, kind):
    """The port's sharded padded driver at n gloo ranks against JAX's
    ShardedDFSPHPadded / ShardedWCSPHPadded on an n-device mesh, the small
    dam-break, 5 steps: equal per-step iterations and drops, sorted live
    positions within atol 5e-5."""
    counts, ref = jax_reference(n, kind)
    run = ranks(n)[0][(kind, "dam")]
    assert run["counts"] == counts
    pos = run["rows"][:, :2].numpy()
    pos = pos[np.lexsort(pos.T)]
    assert pos.shape == ref.shape
    np.testing.assert_allclose(pos, ref, rtol=0, atol=5e-5)
    if kind == "dfsph":
        assert sum(c[1] for c in counts) > len(counts)


def test_refusals():
    """The slot-major route (K3, which has no halo form) under sharding, and
    rows that do not divide over the shards, raise ValueError."""
    world = contact_scene()
    grid = world.dense_grid(ny_multiple=4)
    h = world.properties.smoothing_length
    kw = dict(viscosity_model=TXSPH(h), properties=world.properties,
              step_config=TFixed(1.0 / 250.0))
    group = comm.SpaceGroup(0, 2, "cpu", "gloo")  # no process group is needed to refuse
    with pytest.raises(ValueError, match="slot-major .*no halo"):
        ShardedDFSPHPadded(group, full_grid=dataclasses.replace(grid, use_pallas_slotmajor=True),
                           **kw)
    with pytest.raises(ValueError, match="slot-major .*no halo"):
        DFSPHPaddedShardSolver(grid=dataclasses.replace(grid, use_pallas_slotmajor=True),
                               group=group, **kw)
    with pytest.raises(ValueError, match="must divide"):
        ShardedWCSPHPadded(group, full_grid=dataclasses.replace(grid, ny=grid.ny + 1), **kw)
