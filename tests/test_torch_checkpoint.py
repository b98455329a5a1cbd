"""Checkpoints of the port's carries (utils/checkpoint.py) and their exchange
with the JAX package's (yasph2d_tpu/utils/checkpoint.py), on the scene of
tests/test_config.py:18-31 with physical viscosity, on the CPU.

- Every carry (DFSPH padded and plane, the plane one also with bf16
  operands; WCSPH padded and plane) saved after 2 steps loads into a fresh
  carry of the same build with every leaf bit-equal, and 2 steps from the
  loaded carry are bit-equal to 2 steps from the saved one.
- A padded carry (DFSPH, WCSPH) that the JAX package saved loads into the
  port, and the port's loads into the JAX package, every leaf bit-equal to
  what was saved; then 3 steps of each package from the exchanged carries
  agree to f32 drift (per-step iterations and drops equal, dt to rtol 1e-6,
  sorted live positions to atol 1e-5, densities to rtol 1e-4 / atol 1e-2, as
  tests/test_torch_config.py; the JAX reference is its XLA route).
"""

import jax
import numpy as np
import pytest
import torch

import yasph2d_tpu.config as J
import yasph2d_tpu.utils.checkpoint as jckpt
import yasph2d_tpu_torch.config as T
from yasph2d_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)

KINDS = {  # name -> (config kind, solver knobs)
    "dfsph_padded": ("dfsph_padded", {}),
    "dfsph_padded_k3": ("dfsph_padded", dict(use_pallas_slotmajor=True)),
    "dfsph_plane": ("dfsph_plane", {}),
    "dfsph_plane_bf16": ("dfsph_plane", dict(pair_dtype="bfloat16")),
    "wcsph_padded": ("wcsph_padded", {}),
    "wcsph_plane": ("wcsph_plane", {}),
}


def small_config(mod, kind, **solver):
    """tests/test_config.py:18-31's scene, physical viscosity, in `mod`'s schema."""
    return mod.SimulationConfig(
        fluid=mod.FluidConfig(particle_density=1600.0),
        viscosity=mod.ViscosityConfig(kind="physical", fluid_viscosity=0.01),
        solver=mod.SolverConfig(kind=kind, **solver),
        timestep=mod.TimestepConfig(kind="fixed", fixed_timestep=1.0 / 3000.0),
        scene=[
            mod.FluidRect(rect=(0.1, 0.7, 0.5, 1.0), jitter=0.05),
            mod.BoundaryThickLine(start=(0.0, 0.0), end=(2.0, 0.0), thickness=4),
            mod.BoundaryThickLine(start=(0.0, 0.0), end=(0.0, 2.5), thickness=4),
            mod.BoundaryThickLine(start=(2.0, 0.0), end=(2.0, 2.5), thickness=4),
            mod.BoundaryThickLine(start=(-2.0, -0.5), end=(4.0, -0.5), thickness=4),
        ],
    )


def leaves(carry) -> dict:
    """path -> numpy array of every leaf, as either package's checkpoint
    stores it."""
    if isinstance(carry.time.dt, jax.Array):  # a JAX carry
        names, values, _ = jckpt._paths(carry)
        return {n: np.asarray(v) for n, v in zip(names, values)}
    return {n: tckpt._to_numpy(v) for n, v in tckpt._leaves(carry)}


def bits(x) -> np.ndarray:
    """A float array's bit patterns (so -0.0 != 0.0 and NaNs compare), any
    other array as it is."""
    x = np.ascontiguousarray(x).reshape(-1)
    return x.view(f"u{x.itemsize}") if x.dtype.kind == "f" else x


def assert_bit_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for name in a:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.shape == y.shape, name
        np.testing.assert_array_equal(bits(x), bits(y), err_msg=name)


def run(solver, carry, boundary, steps, simulate=None):
    """(carry, per-step (iterations, drops)) after `steps` steps."""
    simulate = simulate or solver.simulate
    out = []
    for _ in range(steps):
        carry, d = simulate(carry, boundary, 1)
        out.append((int(d.density_iterations), int(d.divergence_iterations),
                    int(d.neighbor_drops)))
    return carry, out


def live_rows(solver, carry) -> np.ndarray:
    s = solver.export_state(carry)
    alive = np.asarray(s.alive)
    rows = np.concatenate([np.asarray(s.positions)[alive],
                           np.asarray(s.densities)[alive][:, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


@pytest.mark.parametrize("name", list(KINDS))
def test_round_trip_and_bitwise_resume(tmp_path, name):
    kind, knobs = KINDS[name]
    _, solver, boundary, carry = small_config(T, kind, **knobs).build(device="cpu")
    template = carry
    carry, _ = run(solver, carry, boundary, 2)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, carry)
    loaded = tckpt.load_checkpoint(path, template)
    assert type(loaded) is type(carry)
    assert_bit_equal(leaves(loaded), leaves(carry))
    # host scalars are state: the warm-start counts and the clock
    assert loaded.time.num_steps == carry.time.num_steps == 2
    assert type(loaded.time.dt) is type(carry.time.dt)
    if kind.startswith("dfsph"):
        assert loaded.prev_divergence_iterations == carry.prev_divergence_iterations
        assert type(loaded.prev_density_iterations) is int
    a, ca = run(solver, carry, boundary, 2)
    b, cb = run(solver, loaded, boundary, 2)
    assert ca == cb
    assert_bit_equal(leaves(a), leaves(b))


def test_missing_leaf_and_shape_mismatch(tmp_path):
    _, solver, boundary, carry = small_config(T, "wcsph_padded").build(device="cpu")
    path = str(tmp_path / "ckpt.npz")
    tckpt.save_checkpoint(path, carry)
    arrays = dict(np.load(path))
    del arrays["accel_pad"]
    np.savez(str(tmp_path / "missing.npz"), **arrays)
    with pytest.raises(KeyError, match="accel_pad"):
        tckpt.load_checkpoint(str(tmp_path / "missing.npz"), carry)
    arrays = dict(np.load(path))
    arrays["dens_pad"] = arrays["dens_pad"][:-1]
    np.savez(str(tmp_path / "shape.npz"), **arrays)
    with pytest.raises(ValueError, match="shape mismatch for dens_pad"):
        tckpt.load_checkpoint(str(tmp_path / "shape.npz"), carry)


@pytest.mark.parametrize("kind", ["dfsph_padded", "wcsph_padded"])
def test_padded_checkpoints_cross_the_packages(tmp_path, kind):
    jcfg = small_config(J, kind)
    _, jsolver, jboundary, jcarry = jcfg.build()
    jsim = jax.jit(jsolver.simulate, static_argnums=2)
    jtemplate = jcarry
    jcarry, _ = run(jsolver, jcarry, jboundary, 2, jsim)
    _, tsolver, tboundary, ttemplate = small_config(T, kind).build(device="cpu")

    # JAX -> port
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(jpath, jcarry)
    tcarry = tckpt.load_checkpoint(jpath, ttemplate)
    saved = dict(np.load(jpath))
    if kind == "dfsph_padded":
        assert "ctx/pos_pad" in saved and "time/target_frame_length" in saved
    assert_bit_equal(leaves(tcarry), saved)
    # port -> JAX
    tpath = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(tpath, tcarry)
    jloaded = jckpt.load_checkpoint(tpath, jtemplate)
    assert_bit_equal(leaves(jloaded), dict(np.load(tpath)))

    jout, jcounts = run(jsolver, jloaded, jboundary, 3, jsim)
    tout, tcounts = run(tsolver, tcarry, tboundary, 3)
    assert tcounts == jcounts
    np.testing.assert_allclose(np.float32(tout.time.dt), np.float32(jout.time.dt), rtol=1e-6)
    trows, jrows = live_rows(tsolver, tout), live_rows(jsolver, jout)
    assert trows.shape == jrows.shape
    np.testing.assert_allclose(trows[:, :2], jrows[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(trows[:, 2], jrows[:, 2], rtol=1e-4, atol=1e-2)
