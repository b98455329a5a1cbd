"""The sharded sorted route of the port (yasph2d_tpu_torch/parallel/
shard_dense.py DFSPHShardMapSolver, ShardedDFSPHDense) on the CPU: gloo
ranks started by `parallel.comm.spawn` (once per rank count for the whole
module), K5's plain twins.

- `_migrate` against JAX's DFSPHShardMapSolver._migrate under shard_map on
  2- and 4-device meshes of the conftest's 8-device CPU platform, on seeded
  blocks of 32 rows a shard with particles across both seams: with room
  (16 slots), with the buffers forced to overflow (4 slots), and with the
  capacity forced to overflow (full blocks receiving arrivals). The new
  block (packed columns and alive flags, dead rows included) bit for bit,
  the drop count equal.
- ShardedDFSPHDense at 2 and 4 ranks against the port's one-device
  DFSPHDenseSolver on the same grid, on the contact scene of
  tests/test_torch_dfsph_padded.py (90 fluid particles) with seeded 3 m/s
  velocities at a fixed dt of 1/250 s, 6 steps, in f32, on a bf16 grid (K5's
  bf16 math mode) and with rebuild_every = 3 (7 steps, one call): per-step
  iterations and neighbour drops equal, no migration drop, every particle
  live, particles sent across the seams, sorted live positions within atol
  5e-5. The rows are not assumed bit-equal (an arrival joins behind the
  shard's rows before the stable cell sort, so it can take another slot in
  its cell than on one device, and K5 sums in slot order); on the bf16
  grid they come out bit-equal (bf16 pair terms round away the last bits
  of the sums), which the test holds.
- The same driver against JAX's ShardedDFSPHDense on 2- and 4-device meshes
  on the same scene, 6 steps, with 32 migration slots, with 1 (the buffers
  overflow: particles stay behind, counted), and at 2 ranks with the
  capacity at the fullest shard's count and a 3 m/s downward drift (a full
  shard receives arrivals: particles are lost, counted): per-step
  iterations, neighbour drops and migration drops equal, the same live
  count, sorted live positions within atol 5e-5 (tests/test_shard_dense.py's
  tolerance).
- One shard's block of JAX's sharded carry after 3 steps converts into the
  port (utils/interop.py) with every leaf bit-equal; each rank resumes
  from its block (`resume` exchanges the halo rows) and 3 more steps agree
  with JAX's. A port checkpoint of a sharded carry (no halo rows saved)
  loads into a fresh carry and resumes bit for bit.
- The refusals: the slot-major route, either loop-gradient flag under
  sharding (on the sorted and the padded drivers), a block beyond its
  capacity, rows that do not divide over the shards.
"""

import dataclasses
import functools
import os
import tempfile

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

import yasph2d_tpu.utils.checkpoint as jckpt
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.parallel.shard_dense import DFSPHShardMapSolver as JShardSolver
from yasph2d_tpu.parallel.shard_dense import ShardedDFSPHDense as JSharded
from yasph2d_tpu.parallel.shard_dense import make_local_grid as j_local_grid
from yasph2d_tpu.parallel.shard_dense import make_space_mesh
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHDenseSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.parallel import comm
from yasph2d_tpu_torch.parallel.shard_dense import (
    DFSPHShardMapSolver,
    ShardedDFSPHDense,
    ShardedDFSPHPadded,
    distribute,
    make_local_grid,
)
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils import checkpoint as tckpt
from yasph2d_tpu_torch.utils.interop import dfsph_dense_carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld
from yasph2d_tpu_torch.world import ParticleState

torch.set_num_threads(1)

AXIS = "space"
RANKS = (2, 4)
STEPS = 6
DT = 1.0 / 250.0
RESUME_RANKS, RESUME_STEPS = 2, 3


# ------------------------------------------------------- _migrate against JAX

N_LOCAL, NX = 32, 6  # rows a block, cells a row
MIGRATE = {"seams": 16, "buffer": 4, "capacity": 16}  # case -> migration_slots


def migrate_world(world_cls):
    return world_cls(2.0, 400.0, 100.0)


H = migrate_world(TWorld).properties.smoothing_length  # the cell size: 0.1


def migrate_blocks(case, n):
    """(packed (n * N_LOCAL, 7) f32, alive) of n seeded shard blocks on a grid
    of 4 rows a shard at n = 2, 2 at n = 4 (8 rows in all): positions in
    columns 0-1, four payload columns, alive as column 6. "seams": 70% live,
    a third of them beyond the shard's rows (either way, up to 1.5 rows);
    "buffer": 90% live, most beyond; "capacity": every row live, the even
    shards' particles inside their rows, the odd shards' half beyond."""
    rng = np.random.default_rng(list(MIGRATE).index(case))
    ny_l = 8 // n
    packed, alive = [], []
    for d in range(n):
        fill = {"seams": 0.7, "buffer": 0.9, "capacity": 1.0}[case]
        a = rng.random(N_LOCAL) < fill
        inside = rng.uniform(d * ny_l, (d + 1) * ny_l, N_LOCAL)
        outside = np.where(rng.random(N_LOCAL) < 0.5, d * ny_l - rng.uniform(0, 1.5, N_LOCAL),
                           (d + 1) * ny_l + rng.uniform(0, 1.5, N_LOCAL))
        share = {"seams": 1 / 3, "buffer": 0.8, "capacity": 0.5 * (d % 2)}[case]
        y = np.clip(np.where(rng.random(N_LOCAL) < share, outside, inside), 0.0, 8 - 1e-3)
        x = rng.uniform(0, NX, N_LOCAL)
        cols = np.concatenate([np.stack([x, y], 1) * H, rng.normal(size=(N_LOCAL, 4)),
                               a[:, None]], axis=1)
        packed.append(np.where(a[:, None], cols, 0.0).astype(np.float32))
        alive.append(a)
    return np.concatenate(packed), np.concatenate(alive)


def jax_migrate(case, n):
    world = migrate_world(JWorld)
    full = JGrid(cell_size=H, origin=(0.0, 0.0), nx=NX, ny=8, occupancy=4)
    solver = JShardSolver(viscosity_model=JXSPH(H), properties=world.properties,
                          grid=j_local_grid(full, n), step_config=JFixed(DT),
                          migration_slots=MIGRATE[case])
    mesh = make_space_mesh(jax.devices()[:n])

    def body(packed, alive):
        return solver._migrate((packed, alive), packed[:, :2], alive)

    spec = JP(AXIS)
    (packed, alive), drops = jax.jit(shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                               out_specs=((spec, spec), JP()),
                                               check_vma=False))(
        *(jnp.asarray(a) for a in migrate_blocks(case, n)))
    return np.asarray(packed), np.asarray(alive), int(drops)


def port_migrate(group, case):
    """This rank's block after the port's _migrate, and the drop count."""
    n, r = group.size, group.rank
    world = migrate_world(TWorld)
    full = TGrid(cell_size=H, origin=(0.0, 0.0), nx=NX, ny=8, occupancy=4)
    solver = DFSPHShardMapSolver(viscosity_model=TXSPH(H), properties=world.properties,
                                 grid=make_local_grid(full, n), step_config=TFixed(DT),
                                 group=group, migration_slots=MIGRATE[case])
    packed, alive = (torch.from_numpy(a[r * N_LOCAL:(r + 1) * N_LOCAL])
                     for a in migrate_blocks(case, n))
    (packed, alive), drops = solver._migrate((packed, alive), packed[:, :2], alive)
    return packed, alive, drops, (int(solver.last_migration["up"]),
                                  int(solver.last_migration["down"]))


# --------------------------------------------------------- the driver's runs

def contact_world(world_cls):
    """tests/test_torch_dfsph_padded.py's contact scene: 90 fluid particles on
    a floor against a wall."""
    world = world_cls(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.05, 0.5, 0.6), 0.05)
    world.add_boundary_thick_line((0.0, 0.0), (2.0, 0.0), 2)
    world.add_boundary_thick_line((0.0, 1.0), (0.0, 0.0), 2)
    return world


def velocities(n, drift=0.0):
    return (np.random.default_rng(42).normal(0.0, 3.0, (n, 2))
            + np.asarray([0.0, drift])).astype(np.float32)


# case -> (pair dtype, rebuild_every, steps a simulate call, calls,
#          migration_slots, capacity, downward drift m/s)
CASES = {
    "f32": ("float32", 1, 1, STEPS, 256, None, 0.0),
    "bf16": ("bfloat16", 1, 1, STEPS, 256, None, 0.0),
    "rebuild3": ("float32", 3, 7, 1, 256, None, 0.0),
    "jax": ("float32", 1, 1, STEPS, 32, None, 0.0),
    "jax_buffer": ("float32", 1, 1, STEPS, 1, None, 0.0),
    "jax_capacity": ("float32", 1, 1, STEPS, 32, 81, 3.0),  # 81: the fullest of 2 shards
}
ONE_DEVICE = ("f32", "bf16", "rebuild3")
AGAINST_JAX = {2: ("jax", "jax_buffer", "jax_capacity"), 4: ("jax", "jax_buffer")}
BIT_EQUAL = ("bf16",)  # cases whose live rows come out bit-equal to one device


def setup(case):
    """(world, full grid, initial state, solver keywords) of a case, on a grid
    whose rows divide over 2 and 4 ranks."""
    dtype, rebuild, _, _, _, _, drift = CASES[case]
    world = contact_world(TWorld)
    grid = dataclasses.replace(world.dense_grid(ny_multiple=4), pair_dtype=dtype)
    state = world.initial_state(device="cpu")
    state = state._replace(velocities=torch.from_numpy(
        velocities(state.positions.shape[0], -drift)))
    kw = dict(viscosity_model=TXSPH(world.properties.smoothing_length),
              properties=world.properties, step_config=TFixed(DT), rebuild_every=rebuild)
    return world, grid, state, kw


def step_counts(d):
    return (d.density_iterations, d.divergence_iterations, d.neighbor_drops)


def driver_run(group, case):
    world, grid, state, kw = setup(case)
    _, _, per_call, calls, slots, capacity, _ = CASES[case]
    sharded = ShardedDFSPHDense(group, full_grid=grid, migration_slots=slots,
                                capacity=capacity, **kw)
    carry, boundary = sharded.init(state, world.boundary_dense(grid, device="cpu"))
    counts, sent = [], 0
    for _ in range(calls):
        carry, d = sharded.simulate(carry, boundary, per_call)
        counts.append(step_counts(d) + (d.migration_drops,))
        sent += sum(int(v) for v in sharded.solver.last_migration.values())
    return dict(counts=counts, rows=sharded.gather_live_rows(carry), sent=sent,
                kinds=(type(sharded.solver).__name__, sharded.solver.grid.ny,
                       int(carry.particles.positions.shape[0])),
                halo=(boundary.halo is not None, carry.ctx.halo is not None))


def resume_from_jax(group, blocks):
    """This rank's block of JAX's sharded carry: converted (its leaves as
    stored), resumed, RESUME_STEPS steps."""
    world, grid, _, kw = setup("jax")
    sharded = ShardedDFSPHDense(group, full_grid=grid, migration_slots=32, **kw)
    leaves = blocks[group.rank]
    carry = dfsph_dense_carry_from_numpy(leaves, device="cpu")
    stored = {n: tckpt._to_numpy(v) for n, v in tckpt._leaves(carry)}
    boundary = sharded._boundary(sharded.local_boundary(world.boundary_dense(grid,
                                                                             device="cpu")))
    carry = sharded.resume(carry)
    counts = []
    for _ in range(RESUME_STEPS):
        carry, d = sharded.simulate(carry, boundary, 1)
        counts.append(step_counts(d) + (d.migration_drops,))
    return dict(stored=stored, counts=counts, rows=sharded.gather_live_rows(carry))


def checkpoint_round_trip(group):
    """A sharded carry after 2 steps saved, loaded into a fresh carry and
    resumed: 2 more steps from each, per rank (bitwise equal?)."""
    world, grid, state, kw = setup("f32")
    sharded = ShardedDFSPHDense(group, full_grid=grid, **kw)
    template, boundary = sharded.init(state, world.boundary_dense(grid, device="cpu"))
    carry, _ = sharded.simulate(template, boundary, 2)
    path = os.path.join(tempfile.mkdtemp(prefix="shard_sorted_"), f"rank{group.rank}.npz")
    tckpt.save_checkpoint(path, carry)
    loaded = tckpt.load_checkpoint(path, template)
    no_halo = loaded.ctx.halo is None
    outs = []
    for c in (carry, sharded.resume(loaded)):
        c, d = sharded.simulate(c, boundary, 2)
        outs.append((step_counts(d), sharded.gather_live_rows(c)))
    return dict(no_halo=no_halo, equal=outs[0][0] == outs[1][0]
                and torch.equal(outs[0][1], outs[1][1]))


def rank_main(group, jax_blocks):
    """Everything this module asks of one gloo rank."""
    n = group.size
    return dict(
        migrate={case: port_migrate(group, case) for case in MIGRATE},
        runs={case: driver_run(group, case) for case in ONE_DEVICE + AGAINST_JAX[n]},
        resume=resume_from_jax(group, jax_blocks) if jax_blocks else None,
        checkpoint=checkpoint_round_trip(group),
    )


@functools.lru_cache(maxsize=None)
def jax_sharded(case, n, steps=STEPS):
    """JAX's ShardedDFSPHDense (XLA route, jitted) on an n-device mesh, on the
    case's scene: per-step counts with migration drops, sorted live
    positions, the carry."""
    _, _, _, _, slots, capacity, drift = CASES[case]
    world = contact_world(JWorld)
    grid = world.dense_grid(ny_multiple=4)
    state = world.initial_state()
    state = state._replace(velocities=jnp.asarray(velocities(state.positions.shape[0],
                                                             -drift)))
    sharded = JSharded(viscosity_model=JXSPH(world.properties.smoothing_length),
                       properties=world.properties, full_grid=grid, step_config=JFixed(DT),
                       mesh=make_space_mesh(jax.devices()[:n]), capacity=capacity,
                       migration_slots=slots)
    carry, boundary = sharded.init(state, world.boundary_dense(grid))
    counts, carries = [], [carry]
    for _ in range(steps):
        carry, d = sharded.simulate(carry, boundary, 1)
        counts.append((int(d.density_iterations), int(d.divergence_iterations),
                       int(d.neighbor_drops), int(d.migration_drops)))
        carries.append(carry)
    return counts, carries


def jax_positions(carry) -> np.ndarray:
    p = carry.particles
    pos = np.asarray(p.positions)[np.asarray(p.alive)]
    return pos[np.lexsort(pos.T)]


def jax_blocks(n) -> list:
    """Each shard's block of the leaves of JAX's sharded carry after
    RESUME_STEPS steps ("jax" case): every array leaf cut along its first
    axis (particles, cell rows, slot rows), scalars as they are."""
    carry = jax_sharded("jax", n)[1][RESUME_STEPS]
    names, values, _ = jckpt._paths(carry)
    blocks = [{} for _ in range(n)]
    for name, value in zip(names, values):
        value = np.asarray(value)
        for r in range(n):
            k = value.shape[0] // n if value.ndim else 0
            blocks[r][name.replace("/", ".")] = value[r * k:(r + 1) * k] if value.ndim else value
    return blocks


@functools.lru_cache(maxsize=None)
def ranks(n):
    return comm.spawn(rank_main, n, "gloo", ["cpu"] * n,
                      jax_blocks(n) if n == RESUME_RANKS else None)


@pytest.fixture(scope="module")
def mesh_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


# ---------------------------------------------------------------------- tests

def sorted_positions(rows) -> np.ndarray:
    p = rows[:, :2].numpy()
    return p[np.lexsort(p.T)]


@pytest.mark.parametrize("case", list(MIGRATE))
@pytest.mark.parametrize("n", RANKS)
def test_migrate_matches_jax(mesh_devices, n, case):
    """Each rank's block after `_migrate` is JAX's shard block bit for bit
    (dead rows included), with the same drop count; particles crossed (both
    ways but in the capacity case, whose senders are the odd shards); the
    overflow cases drop."""
    packed, alive, drops = jax_migrate(case, n)
    results = [r["migrate"][case] for r in ranks(n)]
    got_packed = torch.cat([r[0] for r in results]).numpy()
    got_alive = torch.cat([r[1] for r in results]).numpy()
    np.testing.assert_array_equal(got_packed.view(np.uint32), packed.view(np.uint32))
    np.testing.assert_array_equal(got_alive, alive)
    assert all(r[2] == drops for r in results)
    ups, downs = sum(r[3][0] for r in results), sum(r[3][1] for r in results)
    assert downs > 0 and (ups > 0 or case == "capacity")
    if case == "seams":
        assert drops == 0
    else:
        assert drops > 0
    if case == "capacity":  # live particles were lost, no buffer overflowed
        before = migrate_blocks(case, n)[1].sum()
        assert before - got_alive.sum() == drops
        assert max(r[3][0] for r in results) <= MIGRATE[case]


@functools.lru_cache(maxsize=None)
def one_device(case):
    """The port's one-device sorted solver on the case's grid and state."""
    world, grid, state, kw = setup(case)
    _, _, per_call, calls, _, _, _ = CASES[case]
    solver = TSolver(grid=grid, **kw)
    boundary = world.boundary_dense(grid, device="cpu")
    carry = solver.init_carry(state, boundary)
    counts = []
    for _ in range(calls):
        carry, d = solver.simulate(carry, boundary, per_call)
        counts.append(step_counts(d) + (d.migration_drops,))
    s = solver.export_state(carry)
    rows = torch.cat([s.positions, s.velocities, s.densities[:, None]], 1)[s.alive]
    return counts, rows, int(state.alive.sum())


def lex(rows) -> torch.Tensor:
    r = rows.numpy()
    return torch.from_numpy(r[np.lexsort(r.T[::-1])])


@pytest.mark.parametrize("case", ONE_DEVICE)
@pytest.mark.parametrize("n", RANKS)
def test_sharded_sorted_equals_one_device(n, case):
    """Equal per-step iterations and neighbour drops, no migration drop, every
    particle live, particles sent across the seams, sorted live positions
    within 5e-5 (bit-equal rows on the bf16 grid), on every rank, through
    the shard solver with its halos."""
    counts, rows, n_live = one_device(case)
    assert rows.shape[0] == n_live
    for res in ranks(n):
        run = res["runs"][case]
        assert run["counts"] == counts
        assert all(c[3] == 0 for c in run["counts"])
        assert run["kinds"][0] == "DFSPHShardMapSolver"
        assert run["halo"] == (True, True)  # the halo forms ran
        assert run["rows"].shape == rows.shape
        np.testing.assert_allclose(sorted_positions(run["rows"]), sorted_positions(rows),
                                   rtol=0, atol=5e-5)
        if case in BIT_EQUAL:
            assert torch.equal(lex(run["rows"]).view(torch.int32), lex(rows).view(torch.int32))
    assert sum(res["runs"][case]["sent"] for res in ranks(n)) > 0
    if case == "f32":
        assert max(c[0] for c in counts) > 1 and max(c[1] for c in counts) > 1


@pytest.mark.parametrize("n,case", [(n, c) for n in RANKS for c in AGAINST_JAX[n]])
def test_sharded_sorted_matches_jax(mesh_devices, n, case):
    """The port's driver at n gloo ranks against JAX's ShardedDFSPHDense on an
    n-device mesh: per-step iterations, neighbour drops and migration drops
    equal, the same live count, sorted live positions within 5e-5 (the
    capacity case at 2 shards only: at 4 no shard fills)."""
    counts, carries = jax_sharded(case, n)
    ref = jax_positions(carries[-1])
    for res in ranks(n):
        run = res["runs"][case]
        assert [tuple(c) for c in run["counts"]] == counts
        pos = sorted_positions(run["rows"])
        assert pos.shape == ref.shape
        np.testing.assert_allclose(pos, ref, rtol=0, atol=5e-5)
    migration = sum(c[3] for c in counts)
    if case == "jax":
        assert migration == 0 and ref.shape[0] == 90
    else:
        assert migration > 0
    if case == "jax_capacity":
        assert ref.shape[0] < 90  # live particles lost at a full shard
    elif case == "jax_buffer":
        assert ref.shape[0] == 90  # the unsent stay where they are


def test_one_shard_of_a_jax_carry_resumes(mesh_devices):
    """Each rank's block of JAX's sharded carry converts every leaf bit-equal
    (the halo rows are exchanged anew by `resume`); 3 more steps agree with
    JAX's continuation."""
    blocks = jax_blocks(RESUME_RANKS)
    counts, carries = jax_sharded("jax", RESUME_RANKS)
    ref = jax_positions(carries[2 * RESUME_STEPS])
    assert 2 * RESUME_STEPS == STEPS
    for r, res in enumerate(ranks(RESUME_RANKS)):
        stored = res["resume"]["stored"]
        assert "ctx.slots.inverse" in {n.replace("/", ".") for n in stored}
        for name, value in stored.items():
            leaf = np.asarray(blocks[r][name.replace("/", ".")])
            assert value.shape == leaf.shape, name
            if leaf.dtype.kind == "f":  # bits; the iteration counts are host ints
                assert value.dtype == leaf.dtype, name
                value, leaf = value.view(np.uint32), leaf.view(np.uint32)
            np.testing.assert_array_equal(value, leaf, err_msg=name)
        assert [tuple(c) for c in res["resume"]["counts"]] == counts[RESUME_STEPS:]
        np.testing.assert_allclose(sorted_positions(res["resume"]["rows"]), ref, rtol=0,
                                   atol=5e-5)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_checkpoint_resumes_bitwise(n):
    for res in ranks(n):
        assert res["checkpoint"] == dict(no_halo=True, equal=True)


# ------------------------------------------------------------------ refusals

def refusal_kw():
    world = contact_world(TWorld)
    grid = world.dense_grid(ny_multiple=4)
    kw = dict(viscosity_model=TXSPH(world.properties.smoothing_length),
              properties=world.properties, step_config=TFixed(DT))
    return world, grid, kw


@pytest.mark.parametrize("driver", [ShardedDFSPHDense, ShardedDFSPHPadded],
                         ids=["sorted", "padded"])
@pytest.mark.parametrize("flag", ["cache_loop_gradients", "mxu_loop_gradients",
                                  "use_pallas_slotmajor"])
def test_sharded_refusals(driver, flag):
    """Under sharding: the loop-gradient variants (JAX refuses the MXU form;
    its cache would lose the neighbours across a seam) and the slot-major
    route (no halo form), each a ValueError, also on a one-rank group."""
    _, grid, kw = refusal_kw()
    message = {"cache_loop_gradients": "cache_loop_gradients under sharding",
               "mxu_loop_gradients": "mxu_loop_gradients under sharding",
               "use_pallas_slotmajor": "slot-major .*no halo"}[flag]
    if flag == "use_pallas_slotmajor":
        grid, flags = dataclasses.replace(grid, use_pallas_slotmajor=True), {}
    else:
        flags = {flag: True}
    for size in (1, 2):
        group = comm.SpaceGroup(0, size, "cpu", "gloo")  # no process group is needed
        with pytest.raises(ValueError, match=message):
            driver(group, full_grid=grid, **kw, **flags)
    with pytest.raises(ValueError, match=message):
        DFSPHShardMapSolver(grid=make_local_grid(grid, 2), group=group, **kw, **flags)


def test_capacity_and_row_refusals():
    """A block beyond its capacity, and rows that do not divide over the
    shards, raise ValueError; a block within its capacity is padded with
    dead rows."""
    world, grid, kw = refusal_kw()
    state = world.initial_state(device="cpu")
    with pytest.raises(ValueError, match="shard overflow: 81 live particles > capacity 80"):
        distribute(state, grid, 2, capacity=80)
    blocks = distribute(state, grid, 2, capacity=81)
    assert [int(b.alive.sum()) for b in blocks] == [81, 9]
    assert all(isinstance(b, ParticleState) and b.positions.shape == (81, 2) for b in blocks)
    assert not blocks[1].positions[9:].any() and not blocks[1].alive[9:].any()
    group = comm.SpaceGroup(0, 2, "cpu", "gloo")
    with pytest.raises(ValueError, match="must divide"):
        ShardedDFSPHDense(group, full_grid=dataclasses.replace(grid, ny=grid.ny + 1), **kw)
