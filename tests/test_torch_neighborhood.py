"""The port's neighbour search, pair helpers, Morton codes and table world
functions (yasph2d_tpu_torch/ops/neighborhood.py, ops/pair.py, ops/morton.py,
world.py) against the JAX package's, on the CPU.

- The cell keys, the sort permutation, the boundary's cell grid and both
  neighbour tables (`idx`, `mask`, `count`, `num_dropped`) equal JAX's bit for
  bit, dtypes included, on seeded random positions; with coincident particles
  (the MIN_DISTANCE_SQ filter); with the window and K caps saturated (drops
  counted from both); with particles escaped far outside the scene (clamped
  into the virtual grid's edge cells); and against an empty source space (a
  scene without boundary: all-zero tables).
- The Morton functions equal JAX's exactly (the reference's examples and a
  seeded vectorised sweep, int32 and uint32 tensors).
- `update_neighborhood`, `sort_particles` and `update_densities` against
  JAX's on a seeded scene (the sorted tree bitwise, densities to f32
  rounding: the sums over K are torch's and XLA's); `boundary_grid` is
  cached until the boundary changes; `pad_particles_dense` as JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yasph2d_tpu.ops.morton as JM
import yasph2d_tpu.ops.neighborhood as JN
import yasph2d_tpu.ops.pair as JP
import yasph2d_tpu.world as JW
import yasph2d_tpu_torch.ops.morton as TM
import yasph2d_tpu_torch.ops.neighborhood as TN
import yasph2d_tpu_torch.ops.pair as TP
import yasph2d_tpu_torch.world as TW
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JDenseGrid
from yasph2d_tpu.ops.smoothing_kernels import Poly6 as JPoly6
from yasph2d_tpu.ops.smoothing_kernels import WendlandQuinticC2 as JWendland
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TDenseGrid
from yasph2d_tpu_torch.ops.smoothing_kernels import Poly6 as TPoly6
from yasph2d_tpu_torch.ops.smoothing_kernels import WendlandQuinticC2 as TWendland

torch.set_num_threads(1)


def scattered(seed, n, extent):
    return np.random.default_rng(seed).random((n, 2), dtype=np.float32) * extent


def coincident(seed):
    """Random positions with runs of exact duplicates (self / degenerate pairs)."""
    pos = scattered(seed, 600, 2.0)
    pos[100:140] = pos[0]
    pos[200:205] = pos[50]
    return pos


def escaped(seed):
    """Most particles in a 2 m box, some far outside it, some at +-1e6 m."""
    pos = scattered(seed, 800, 2.0)
    pos[:40] += 500.0
    pos[40:60] -= 2500.0
    pos[60:65] = [[1e6, -1e6], [-1e6, 1e6], [3e5, 3e5], [-7e4, 0.5], [0.5, 9e5]]
    return pos


# name -> (fluid positions, boundary positions, GridConfig keywords)
CASES = {
    "random": (scattered(1, 1500, 3.0), scattered(2, 400, 3.0), dict(cell_size=0.1)),
    "coincident": (coincident(3), scattered(4, 200, 2.0), dict(cell_size=0.1)),
    "saturated": (scattered(5, 2000, 1.5), scattered(6, 900, 1.5),
                  dict(cell_size=0.2, window=8, max_neighbors_dynamic=12,
                       max_neighbors_static=5)),
    "escaped": (escaped(7), scattered(8, 300, 2.0), dict(cell_size=0.1)),
    "empty_source": (scattered(9, 700, 2.0), np.zeros((0, 2), np.float32),
                     dict(cell_size=0.1)),
}


def assert_same(jax_value, port_value, what):
    x, y = np.asarray(jax_value), port_value.numpy()
    assert x.dtype == y.dtype, (what, x.dtype, y.dtype)
    np.testing.assert_array_equal(x, y, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_neighbor_tables_equal_jax(name):
    fluid, boundary, grid_kw = CASES[name]
    jg, tg = JN.GridConfig(**grid_kw), TN.GridConfig(**grid_kw)
    jkeys, jperm = JN.sort_by_cell_keys(jnp.asarray(fluid), jg)
    tkeys, tperm = TN.sort_by_cell_keys(torch.as_tensor(fluid), tg)
    assert_same(JN.cell_keys(jnp.asarray(fluid), jg), TN.cell_keys(torch.as_tensor(fluid), tg),
                "cell keys")
    assert_same(jkeys, tkeys, "sorted keys")
    assert_same(jperm, tperm, "permutation")
    jb = JN.build_cell_grid(jnp.asarray(boundary), jg)
    tb = TN.build_cell_grid(torch.as_tensor(boundary), tg)
    for f in JN.CellGrid._fields:
        assert_same(getattr(jb, f), getattr(tb, f), f"boundary {f}")

    jpos = jnp.asarray(fluid)[jperm]
    tpos = torch.as_tensor(fluid)[tperm]
    jn = JN.build_neighborhood(jpos, jkeys, jb, jg)
    tn = TN.build_neighborhood(tpos, tkeys, tb, tg)
    for table in TN.Neighborhood._fields:
        for f in TN.NeighborTable._fields:
            assert_same(getattr(getattr(jn, table), f), getattr(getattr(tn, table), f),
                        f"{table}.{f}")

    dyn, stat = tn.dynamic, tn.static
    if name == "saturated":  # both caps hit, in both tables
        assert int(dyn.num_dropped) > 0 and int(stat.num_dropped) > 0
        assert int(dyn.count.max()) == tg.max_neighbors_dynamic
    elif name == "empty_source":
        assert not stat.mask.any() and not stat.idx.any() and not stat.count.any()
        assert int(stat.num_dropped) == 0 and int(dyn.count.sum()) > 0
    else:
        assert int(stat.count.sum()) > 0
        # 41 copies of one point overflow the 32-candidate window of their cell
        assert (int(dyn.num_dropped) > 0) == (name == "coincident")
    if name == "coincident":  # the exact duplicates are no neighbours of each other
        first = int(torch.nonzero(tpos.eq(torch.as_tensor(fluid[0])).all(1))[0])
        same = tpos[dyn.idx[first].long()].eq(tpos[first]).all(1) & dyn.mask[first]
        assert not same.any()
    if name == "escaped":
        keys = TN.cell_keys(torch.as_tensor(fluid), tg)
        cx, cy = keys % tg.row_width, keys // tg.row_width
        assert int(cx.min()) == 1 and int(cx.max()) == tg.row_width - 2
        assert int(cy.min()) == 1 and int(cy.max()) == tg.num_rows - 2


def test_pair_helpers_equal_jax():
    rng = np.random.default_rng(11)
    pos = rng.random((50, 2), dtype=np.float32)
    idx = rng.integers(0, 50, (50, 7)).astype(np.int32)
    mask = rng.random((50, 7)) < 0.6
    jp, tp = jnp.asarray(pos), torch.as_tensor(pos)
    jg, tg = JP.gather(jp, jnp.asarray(idx)), TP.gather(tp, torch.as_tensor(idx))
    assert_same(jg, tg, "gather")
    for a, b in zip(JP.pair_geometry(jp, jg), TP.pair_geometry(tp, tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    vals = rng.normal(size=(50, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(
        TP.masked_sum(torch.as_tensor(vals), torch.as_tensor(mask)).numpy(),
        np.asarray(JP.masked_sum(jnp.asarray(vals), jnp.asarray(mask))), rtol=1e-6, atol=1e-6)
    empty = TP.gather(torch.zeros((0, 2)), torch.as_tensor(idx))
    assert empty.shape == (50, 7, 2) and not empty.any()


# ------------------------------------------------------------------- morton


def test_morton_examples_equal_jax():
    for x, y in ((2, 2), (3, 6), (4, 0), (0b1111_0001_0010_0000, 0b1001_1101_1000_1100)):
        code = TM.encode(torch.tensor([x], dtype=torch.uint32),
                         torch.tensor([y], dtype=torch.uint32))
        ref = JM.encode(np.uint32(x), np.uint32(y))
        assert int(code) == int(ref) and code.dtype == torch.uint32
        assert int(TM.decode_x(code)) == x and int(TM.decode_y(code)) == y
    for args in ((16, 12, 45), (19, 12, 45), (29, 12, 45), (35, 12, 45), (14, 12, 45),
                 (15, 12, 45)):
        assert TM.find_bigmin(*args) == JM.find_bigmin(*args)
    for code in (13, 16, 12, 45, 46):
        t = torch.tensor([code], dtype=torch.uint32)
        assert bool(TM.is_in_rect(t, 2, 2, 3, 6)) == bool(JM.is_in_rect(np.uint32(code),
                                                                       2, 2, 3, 6))


def check_presplit(code, ref):
    """is_in_rect_presplit on the codes' own bounding rect, against JAX's."""
    lo, hi = ref.min(), ref.max()
    bounds = (lo & JM.MORTON_XBITS, lo & JM.MORTON_YBITS, hi & JM.MORTON_XBITS,
              hi & JM.MORTON_YBITS)
    np.testing.assert_array_equal(TM.is_in_rect_presplit(code, *(int(v) for v in bounds))
                                  .numpy(), JM.is_in_rect_presplit(ref, *bounds))


@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_morton_vectorised_equal_jax(dtype):
    rng = np.random.default_rng(12)
    x = rng.integers(0, 1 << 15, 2000)
    y = rng.integers(0, 1 << 15, 2000)
    np_dtype = np.int32 if dtype == torch.int32 else np.uint32
    tx, ty = torch.as_tensor(x.astype(np_dtype)), torch.as_tensor(y.astype(np_dtype))
    code = TM.encode(tx, ty)
    ref = JM.encode(x.astype(np_dtype), y.astype(np_dtype))
    np.testing.assert_array_equal(code.numpy(), ref)
    np.testing.assert_array_equal(TM.decode_x(code).numpy(), JM.decode_x(ref))
    np.testing.assert_array_equal(TM.decode_y(code).numpy(), JM.decode_y(ref))
    if dtype == torch.uint32:  # the y bit mask 0xAAAAAAAA needs 32 unsigned bits
        check_presplit(code, ref)
    cx = rng.integers(-5, 40000, 500).astype(np.int32)
    cy = rng.integers(-5, 40000, 500).astype(np.int32)
    assert_same(JM.cell_key_morton(jnp.asarray(cx), jnp.asarray(cy)),
                TM.cell_key_morton(torch.as_tensor(cx), torch.as_tensor(cy)), "morton key")


# ------------------------------------------------------------------- world


def tank(world_cls):
    world = world_cls(2.0, 900.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def test_world_functions_equal_jax():
    jw, tw = tank(JW.FluidParticleWorld), tank(TW.FluidParticleWorld)
    assert tw.grid == TN.GridConfig(cell_size=tw.properties.smoothing_length)
    jb, tb = jw.boundary_grid(), tw.boundary_grid(device="cpu")
    for f in JN.CellGrid._fields:
        assert_same(getattr(jb, f), getattr(tb, f), f"boundary_grid {f}")
    assert tw.boundary_grid(device="cpu") is tb  # cached
    rng = np.random.default_rng(13)
    js, ts = jw.initial_state(), tw.initial_state(device="cpu")
    vel = rng.normal(size=tuple(ts.velocities.shape)).astype(np.float32)
    js = js._replace(velocities=jnp.asarray(vel))
    ts = ts._replace(velocities=torch.as_tensor(vel))

    jtree, jpos, jnbh = JW.update_neighborhood(js, js.positions, jb, jw.grid)
    ttree, tpos, tnbh = TW.update_neighborhood(ts, ts.positions, tb, tw.grid)
    assert type(ttree) is TW.ParticleState
    for f in TW.ParticleState._fields:
        assert_same(getattr(jtree, f), getattr(ttree, f), f)
    assert_same(jpos, tpos, "sorted positions")
    for table in TN.Neighborhood._fields:
        for f in TN.NeighborTable._fields:
            assert_same(getattr(getattr(jnbh, table), f), getattr(getattr(tnbh, table), f), f)
    (jv,), jkeys, jperm = JW.sort_particles((js.velocities,), js.positions, jw.grid)
    (tv,), tkeys, tperm = TW.sort_particles((ts.velocities,), ts.positions, tw.grid)
    assert_same(jv, tv, "sorted velocities")
    assert_same(jperm, tperm, "perm")

    m, rho0 = tw.properties.particle_mass, tw.properties.fluid_density
    h = tw.properties.smoothing_length
    # rho0 = 0 shows the sums themselves (the lattice rests under rho0)
    for jk, tk, floor in ((JPoly6(h), TPoly6(h), rho0), (JWendland(h), TWendland(h), rho0),
                          (JWendland(h), TWendland(h), 0.0)):
        jd = JW.update_densities(jpos, jnbh, jb.positions, jk, m, floor)
        td = TW.update_densities(tpos, tnbh, tb.positions, tk, m, floor)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
        assert float(td.min()) >= floor
    assert float(td.max()) > float(td.min()) > 0.0

    tw.add_boundary_line((0.0, 1.5), (1.0, 1.5))  # a change rebuilds the cache
    assert tw.boundary_grid(device="cpu").positions.shape[0] > tb.positions.shape[0]
    tw.remove_all_boundary_particles()
    assert tw.boundary_grid(device="cpu").positions.shape == (0, 2)


def test_pad_particles_dense_equals_jax():
    jw, tw = tank(JW.FluidParticleWorld), tank(TW.FluidParticleWorld)
    jgrid, tgrid = jw.dense_grid(), tw.dense_grid()
    assert JDenseGrid(**{f: getattr(jgrid, f) for f in ("cell_size", "origin", "nx", "ny",
                                                        "occupancy")}) == jgrid
    assert TDenseGrid(**{f: getattr(tgrid, f) for f in ("cell_size", "origin", "nx", "ny",
                                                        "occupancy")}) == tgrid
    js, ts = jw.initial_state(), tw.initial_state(device="cpu")
    for multiple in (1, 8, 64):
        jp = JW.pad_particles_dense(js, multiple, jgrid)
        tp = TW.pad_particles_dense(ts, multiple, tgrid)
        for f in TW.ParticleState._fields:
            assert_same(getattr(jp, f), getattr(tp, f), f)
        assert tp.positions.shape[0] % multiple == 0
