"""PyTorch port vs JAX package: scene construction, dense grid sizing, the
static boundary index space and the initial slot layout — all exactly equal."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JPadded
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.ops import dense_grid as jdg
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.utils import compile_cache
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch import scenes
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TPadded
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.ops import dense_grid as tdg
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def verify_scene(world_cls):
    """The reference app's default dam-break (main.rs:177-196): 4050 fluid /
    6840 boundary particles."""
    world = world_cls(2.0, 10000.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    for args in [((0.0, 2.5), (2.0, 2.5), 4), ((0.0, 0.0), (2.0, 0.0), 4),
                 ((0.0, 0.0), (0.0, 2.5), 4), ((2.0, 0.0), (2.0, 2.5), 4),
                 ((0.0, 0.6), (1.75, 0.5), 2), ((0.0, 2.5), (2.0, 2.5), 2),
                 ((-2.0, -0.5), (4.0, -0.5), 4)]:
        world.add_boundary_thick_line(*args)
    return world


@pytest.fixture(scope="module")
def jax_bench(monkeypatch_module):
    """bench.py's scene functions (imported without enabling its persistent
    compile cache)."""
    monkeypatch_module.setattr(compile_cache, "enable", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location("_bench_scenes", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module", params=["verify", "double_dam_break_10k"])
def worlds(request, jax_bench):
    if request.param == "verify":
        return verify_scene(JWorld), verify_scene(TWorld)
    return jax_bench.double_dam_break(10_000), scenes.double_dam_break(10_000)


def test_verify_scene_counts():
    world = verify_scene(TWorld)
    assert world.num_dynamic_particles == 4050
    assert world.num_boundary_particles == 6840


def test_scene_positions_bit_equal(worlds):
    jw, tw = worlds
    assert tw.num_dynamic_particles == jw.num_dynamic_particles
    for getter in ("host_positions", "host_boundary_positions"):
        a, b = getattr(jw, getter)(), getattr(tw, getter)()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(b.view(np.uint32), a.view(np.uint32))
    np.testing.assert_array_equal(
        tw.initial_state(device="cpu").positions.numpy(), np.asarray(jw.initial_state().positions)
    )


@pytest.mark.parametrize("occupancy", [None, 7])
def test_dense_grid_fields_equal(worlds, occupancy):
    jw, tw = worlds
    jg, tg = jw.dense_grid(occupancy=occupancy), tw.dense_grid(occupancy=occupancy)
    for field in ("cell_size", "origin", "nx", "ny", "occupancy", "radius_sq",
                  "num_cells"):
        assert getattr(tg, field) == getattr(jg, field), field


def test_boundary_dense_exact(worlds):
    jw, tw = worlds
    jg, tg = jw.dense_grid(occupancy=7), tw.dense_grid(occupancy=7)
    jb, tb = jw.boundary_dense(jg), tw.boundary_dense(tg, device="cpu")
    assert tb.pos_pad.shape == tuple(jb.pos_pad.shape)
    np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
    np.testing.assert_array_equal(tb.pos_pad.numpy(), np.asarray(jb.pos_pad))
    assert int(tb.num_dropped) == int(jb.num_dropped)


def test_slot_build_exact(worlds):
    """cell keys, stable sort, slot grid and padding, on the scene and on a
    copy with dead (alive == False) particles and forced cell overflow."""
    jw, tw = worlds
    jg, tg = jw.dense_grid(occupancy=2), tw.dense_grid(occupancy=2)
    pos = jw.host_positions()
    alive = np.random.default_rng(0).random(pos.shape[0]) < 0.9
    for alive_arg in (None, alive):
        ja = None if alive_arg is None else jnp.asarray(alive_arg)
        ta = None if alive_arg is None else torch.as_tensor(alive_arg)
        (jpos,), jkeys = jdg.sort_by_dense_keys((jnp.asarray(pos),), jnp.asarray(pos), jg, ja)
        (tpos,), tkeys = tdg.sort_by_dense_keys((torch.as_tensor(pos),),
                                                torch.as_tensor(pos), tg, ta)
        np.testing.assert_array_equal(tkeys.numpy(), np.asarray(jkeys))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        js, ts = jdg.build_slot_grid(jkeys, jg), tdg.build_slot_grid(tkeys, tg)
        for field in tdg.SlotGrid._fields:
            np.testing.assert_array_equal(
                getattr(ts, field).numpy(), np.asarray(getattr(js, field)), err_msg=field
            )
        assert int(ts.num_dropped) > 0  # occupancy 2 overflows the packed lattice
        np.testing.assert_array_equal(
            tdg.pad_to_slots(tpos, ts, tg).numpy(),
            np.asarray(jdg.pad_to_slots(jpos, js, jg)),
        )


def test_padded_init_exact(worlds):
    """DFSPHPaddedSolver.init_carry's slot layout: the JAX package's composition
    of sort / slot grid / padding against the port's `_padded_init`."""
    jw, tw = worlds
    jg, tg = jw.dense_grid(occupancy=7), tw.dense_grid(occupancy=7)
    h = jw.properties.smoothing_length
    port = TPadded(viscosity_model=TXSPH(h), properties=tw.properties, grid=tg,
                   step_config=TFixed(1.0 / 3000.0))
    ref = JPadded(viscosity_model=JXSPH(h), properties=jw.properties, grid=jg,
                  step_config=JFixed(1.0 / 3000.0))
    jb, tb = jw.boundary_dense(jg), tw.boundary_dense(tg, device="cpu")
    state = jw.initial_state()
    (sorted_state,), keys = ref._sort((state,), state.positions, state.alive)
    slots = jdg.build_slot_grid(keys, jg)
    init = port._padded_init(tw.initial_state(device="cpu"), tb)
    np.testing.assert_array_equal(
        init.pos_pad.numpy(), np.asarray(jdg.pad_to_slots(sorted_state.positions, slots, jg))
    )
    np.testing.assert_array_equal(
        init.mask.numpy(),
        np.asarray(slots.slot_mask).reshape(jg.ny, jg.nx, jg.occupancy),
    )
    assert int(init.num_dropped) == int(slots.num_dropped) + int(jb.num_dropped) == 0
    assert int(init.mask.sum()) == tw.num_dynamic_particles
    assert not init.v_pad.any() and not init.kappa_pad.any()
    assert (init.prev_density_iterations, init.prev_divergence_iterations) == (1, 0)
    assert init.time.dt == np.float32(1.0 / 3000.0)


def test_scene_tensors_default_to_the_card(worlds):
    """`initial_state` and `boundary_dense` make CUDA tensors unless asked for
    the CPU; without a CUDA device the default fails as torch fails, with no
    fallback to the CPU."""
    _, tw = worlds
    grid = tw.dense_grid(occupancy=7)
    if torch.cuda.is_available():
        assert tw.initial_state().positions.is_cuda
        assert tw.boundary_dense(grid).pos_pad.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tw.initial_state()
        with pytest.raises((AssertionError, RuntimeError)):
            tw.boundary_dense(grid)
    assert tw.initial_state(device="cpu").positions.device.type == "cpu"
