"""The loop-gradient variants of the port's DFSPH slot solvers
(`cache_loop_gradients`, `mxu_loop_gradients`, yasph2d_tpu_torch/models/
dfsph_dense.py) and the grid functions they run on (ops/dense_grid.py
`neighbor_windows`, `pair_map`, `cached_pair_reduce`) against the JAX
package's, on the CPU.

- `neighbor_windows` bit for bit; `pair_map` bit for bit where its
  operations are JAX's (the validity mask, the pair vectors and r_sq), the
  kernel gradient through it within rtol 1e-6 (the CPU's torch.sqrt is not
  correctly rounded, ROADMAP Queue 3); `cached_pair_reduce` of the loop
  passes' closures on JAX's own cache within the cancellation tolerance
  (rtol 1e-5 plus 1e-6 of the component's largest magnitude): the sums over
  the candidate axis come in another order.
- The cached form of the sorted and of the padded solver against JAX's same
  flag on the contact scene of tests/test_torch_dense_sorted.py (seeded 3
  m/s velocities, fixed dt, both loops iterate and warm-start), 5 steps:
  per-step iterations and drops equal, positions within atol 1e-5.
- The MXU form: its two contractions on JAX's own pair context (converted
  through utils/interop.py, so both sides hold the same bf16 gradients)
  against JAX's `dot_general` within 1e-5 of the plane's scale (the
  contraction sums 18P products in another order), and the bounds of
  JAX's test_mxu_loop_gradients_tracks_reference_path
  (tests/test_dfsph_padded.py:202-240) against the port's exact path on
  its scene, the small dam-break, here at 400 particles a square metre
  with the fitted occupancy (JAX's 1600 and occupancy 12 take two minutes
  through the CPU twins): no drop, finite, density iterations within 2 and
  divergence iterations within 4 over 15 steps, mean position within
  0.02 h, sorted y within 0.25 h. Its carry against JAX's MXU carry over
  the same 5 contact steps as the cached form.
- JAX carries with the caches (f32 and bf16) load into the port through
  utils/interop.py and utils/checkpoint.py every leaf bit-equal (the bf16
  cache from JAX's .npz as raw two-byte elements), and the runs from there
  agree.
- Every refusal, each a ValueError: JAX's asserts (the cache with bf16 pair
  math, the two flags together, either on the K3 route) on both solvers
  and on the plane solver.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yasph2d_tpu.utils.checkpoint as jckpt
import yasph2d_tpu.world as JW
import yasph2d_tpu_torch.world as TW
from test_torch_dfsph_padded import contact_scene
from yasph2d_tpu.models.dfsph_dense import DFSPHDenseSolver as JDense
from yasph2d_tpu.models.dfsph_dense import DFSPHPaddedSolver as JPadded
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.ops import dense_grid as jdg
from yasph2d_tpu.ops.smoothing_kernels import WendlandQuinticC2 as JKernel
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHDenseSolver as TDense
from yasph2d_tpu_torch.models.dfsph_dense import DFSPHPaddedSolver as TPadded
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TPlane
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.ops import dense_grid as tdg
from yasph2d_tpu_torch.ops.smoothing_kernels import WendlandQuinticC2 as TKernel
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils import checkpoint as tckpt
from yasph2d_tpu_torch.utils.interop import (
    dfsph_dense_carry_from_numpy,
    dfsph_padded_carry_from_numpy,
)

torch.set_num_threads(1)

STEPS = 5
NOISE = 3.0  # m/s
SOLVERS = {"dense": (JDense, TDense), "padded": (JPadded, TPadded)}
FLAGS = ("cache_loop_gradients", "mxu_loop_gradients")


# ------------------------------------------------------------- grid functions

def slot_grid(seed, ny=5, nx=4, p=3, h=1.0):
    """Seeded live slots near their cells (a tenth of a cell outside, so pairs
    cross cells), a velocity and a scalar per slot."""
    rng = np.random.default_rng(seed)
    mask = rng.random((ny, nx, p)) < 0.6
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    pos = (np.stack([ix, iy], -1)[:, :, None] + rng.random((ny, nx, p, 2)) * 1.2 - 0.1) * h
    pos = np.where(mask[..., None], pos, 0.0).astype(np.float32)
    v = (rng.normal(size=(ny, nx, p, 2)) * mask[..., None]).astype(np.float32)
    k = (rng.normal(size=(ny, nx, p)) * mask).astype(np.float32)
    grid = (jdg.DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p),
            tdg.DenseGridConfig(cell_size=h, origin=(0.0, 0.0), nx=nx, ny=ny, occupancy=p))
    return grid, pos, mask, v, k


@pytest.mark.parametrize("what", ["positions", "mask", "scalar"])
def test_neighbor_windows_match_jax(what):
    _, pos, mask, _, k = slot_grid(0)
    a = {"positions": pos, "mask": mask, "scalar": k}[what]
    got = tdg.neighbor_windows(torch.from_numpy(a)).numpy()
    ref = np.asarray(jdg.neighbor_windows(jnp.asarray(a)))
    assert got.shape == (5, 4, 27) + a.shape[3:]
    np.testing.assert_array_equal(got, ref)
    # the centre view (dy, dx) = (1, 1) is the cell itself; the border is zero
    np.testing.assert_array_equal(got[:, :, 12:15], a)
    assert not got[0, :, :9].any() and not got[:, 0, ::9].any()


def test_pair_map_matches_jax():
    """The per-pair map with JAX's validity test: the pair vectors and r_sq
    bit for bit (tuple leaves of two shapes), exact zeros off the valid
    pairs; the kernel gradient within rtol 1e-6."""
    (jgrid, tgrid), pos, mask, _, _ = slot_grid(1)
    jargs = (jnp.asarray(pos), jnp.asarray(mask)) * 2
    targs = (torch.from_numpy(pos), torch.from_numpy(mask)) * 2
    ref = jdg.pair_map(lambda rij, r_sq, r: (rij, r_sq), *jargs, jgrid)
    got = tdg.pair_map(lambda rij, r_sq, r: (rij, r_sq), *targs, tgrid)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    valid = got[1] > 0
    assert 0 < int(valid.sum()) < valid.numel()
    h = jgrid.cell_size
    jg = jdg.pair_map(lambda rij, r_sq, r: JKernel(h).gradient(rij, r_sq, r), *jargs, jgrid)
    tg = tdg.pair_map(lambda rij, r_sq, r: TKernel(h).gradient(rij, r_sq, r), *targs, tgrid)
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0 and not tg[~valid].any()
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7 * scale)


@pytest.mark.parametrize("closure", ["divergence", "correction"])
def test_cached_pair_reduce_matches_jax(closure):
    """The loop passes' closures (JAX dfsph_dense.py:371-376, 421-426) over
    JAX's own cached gradients."""
    (jgrid, _), pos, mask, v, k = slot_grid(2)
    cache = jdg.pair_map(lambda rij, r_sq, r: JKernel(1.0).gradient(rij, r_sq, r),
                         *(jnp.asarray(pos), jnp.asarray(mask)) * 2, jgrid)
    vals = v if closure == "divergence" else k
    if closure == "divergence":
        jfn = lambda g, vi, vj: jnp.sum((vi - vj) * g, axis=-1)  # noqa: E731
        tfn = lambda g, vi, vj: ((vi - vj) * g).sum(dim=-1)  # noqa: E731
    else:
        jfn = lambda g, ki, kj: (ki + kj)[..., None] * g  # noqa: E731
        tfn = lambda g, ki, kj: (ki + kj)[..., None] * g  # noqa: E731
    ref = np.asarray(jdg.cached_pair_reduce(jfn, cache, (jnp.asarray(vals),),
                                            (jnp.asarray(vals),)))
    got = tdg.cached_pair_reduce(tfn, torch.from_numpy(np.array(cache)),
                                 (torch.from_numpy(vals),), (torch.from_numpy(vals),)).numpy()
    assert got.shape == ref.shape == vals.shape[:3] + ref.shape[3:]
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)


# ------------------------------------------------------------------ solvers

def build(side, kind, world=None, step=None, **flags):
    """(world, solver, boundary) of one package (side 0 JAX, 1 the port) on
    the contact scene (or `world`), fixed dt 1/250 s (or `step`)."""
    world = world or contact_scene((JW.FluidParticleWorld, TW.FluidParticleWorld)[side])
    h = world.properties.smoothing_length
    grid = world.dense_grid()
    step = step or (JFixed, TFixed)[side](1.0 / 250.0)
    s = SOLVERS[kind][side](viscosity_model=(JXSPH, TXSPH)[side](h),
                            properties=world.properties, grid=grid, step_config=step, **flags)
    boundary = world.boundary_dense(grid) if side == 0 else \
        world.boundary_dense(grid, device="cpu")
    return world, s, boundary


def noisy_state(side, world):
    state = world.initial_state() if side == 0 else world.initial_state(device="cpu")
    v = np.random.default_rng(42).normal(0.0, NOISE, tuple(state.velocities.shape))
    v = v.astype(np.float32)
    return state._replace(velocities=jnp.asarray(v) if side == 0 else torch.as_tensor(v))


def run(side, s, carry, boundary, steps):
    """(carry, per-step (density its, divergence its, drops))."""
    simulate = jax.jit(s.simulate, static_argnums=2) if side == 0 else s.simulate
    out = []
    for _ in range(steps):
        carry, d = simulate(carry, boundary, 1)
        out.append((int(d.density_iterations), int(d.divergence_iterations),
                    int(d.neighbor_drops)))
    return carry, out


def sorted_positions(s, carry) -> np.ndarray:
    st = s.export_state(carry) if hasattr(s, "export_state") else carry.particles
    pos = np.asarray(st.positions)[np.asarray(st.alive)]
    return pos[np.lexsort(pos.T)]


@functools.lru_cache(maxsize=None)
def jax_run(kind, flag):
    world, s, boundary = build(0, kind, **{flag: True})
    c0 = jax.jit(s.init_carry)(noisy_state(0, world), boundary)
    c, counts = run(0, s, c0, boundary, STEPS)
    return c0, c, counts, sorted_positions(s, c)


def port_run(kind, flag, steps=STEPS):
    world, s, boundary = build(1, kind, **({flag: True} if flag else {}))
    c0 = s.init_carry(noisy_state(1, world), boundary)
    c, counts = run(1, s, c0, boundary, steps)
    return s, c, counts


@pytest.mark.parametrize("kind", list(SOLVERS))
@pytest.mark.parametrize("flag", FLAGS)
def test_loop_gradient_solver_matches_jax(kind, flag):
    """5 contact steps of the flagged solver against JAX's with the same flag:
    per-step iterations and drops equal, sorted live positions within atol
    1e-5; the cache is live (the loops iterate) and has JAX's dtype."""
    s, c, counts = port_run(kind, flag)
    _, jc, jcounts, jpos = jax_run(kind, flag)
    assert counts == jcounts
    assert max(x[0] for x in counts) > 1 and max(x[1] for x in counts) > 1
    np.testing.assert_allclose(sorted_positions(s, c), jpos, rtol=0, atol=1e-5)
    g = c.ctx.grad_dyn
    assert g.dtype == (torch.bfloat16 if flag.startswith("mxu") else torch.float32)
    assert tuple(g.shape) == tuple(jc.ctx.grad_dyn.shape) == tuple(c.ctx.mask.shape) + (
        9 * s.grid.occupancy, 2)
    assert (c.ctx.sum_grad_dyn is None) == flag.startswith("cache")


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_cached_form_is_the_exact_path(kind):
    """The cached f32 form has the exact path's per-step iterations and
    drops (the same pair terms, summed in another order)."""
    assert port_run(kind, "cache_loop_gradients")[2] == port_run(kind, None)[2]


@pytest.mark.parametrize("which", ["divergence", "correction"])
def test_mxu_contraction_matches_jax(which):
    """The MXU form's passes on JAX's MXU pair context after 3 contact steps
    (the same bf16 G and f32 row sums on both sides), with seeded loop
    values: within 1e-5 of the output's scale."""
    world, js, jb = build(0, "padded", mxu_loop_gradients=True)
    jc = jax.jit(js.init_carry)(noisy_state(0, world), jb)
    jc, _ = run(0, js, jc, jb, 3)
    names, values, _ = jckpt._paths(jc)
    leaves = {n.replace("/", "."): np.asarray(v) for n, v in zip(names, values)}
    tc = dfsph_padded_carry_from_numpy(leaves, device="cpu")
    assert tc.ctx.grad_dyn.dtype == torch.bfloat16
    _, ts, _ = build(1, "padded", mxu_loop_gradients=True)
    rng = np.random.default_rng(7)
    mask = np.asarray(jc.ctx.mask)
    if which == "divergence":
        x = (rng.normal(size=mask.shape + (2,)) * mask[..., None]).astype(np.float32)
        ref = js._velocity_divergence(jc.ctx, jnp.asarray(x))
        got = ts._velocity_divergence(tc.ctx, torch.from_numpy(x))
    else:
        x = (rng.normal(size=mask.shape) * 1e4 * mask).astype(np.float32)
        ref = js._k_correction(jc.ctx, jnp.asarray(x))
        got = ts._k_correction(tc.ctx, torch.from_numpy(x))
    ref = np.asarray(ref)
    scale = float(np.abs(ref[mask]).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy()[mask], ref[mask], rtol=0, atol=1e-5 * scale)


def test_mxu_tracks_the_exact_path():
    """JAX's test_mxu_loop_gradients_tracks_reference_path on the port: the
    small dam-break (at 400 particles a square metre), fixed dt 1/3000 s,
    15 steps of the padded solver with and without the MXU form."""
    from test_wcsph import small_dam_break

    jworld = small_dam_break(particle_density=400.0)
    world = TW.FluidParticleWorld(2.0, 400.0, 100.0)
    world.add_fluid_rect((0.1, 0.7, 0.5, 1.0), 0.05)
    for a, b, t in (((0.0, 2.5), (2.0, 2.5), 4), ((0.0, 0.0), (2.0, 0.0), 4),
                    ((0.0, 0.0), (0.0, 2.5), 4), ((2.0, 0.0), (2.0, 2.5), 4),
                    ((0.0, 0.6), (1.75, 0.5), 2), ((0.0, 2.5), (2.0, 2.5), 2),
                    ((-2.0, -0.5), (4.0, -0.5), 4)):
        world.add_boundary_thick_line(a, b, t)
    assert world.num_dynamic_particles == jworld.num_dynamic_particles
    h = world.properties.smoothing_length
    grid = world.dense_grid()
    boundary = world.boundary_dense(grid, device="cpu")

    def go(**flags):
        s = TPadded(viscosity_model=TXSPH(h), properties=world.properties, grid=grid,
                    step_config=TFixed(1.0 / 3000.0), **flags)
        c = s.init_carry(world.initial_state(device="cpu"), boundary)
        c, d = s.simulate(c, boundary, 15)
        st = s.export_state(c)
        return st.positions[st.alive].numpy(), d

    pos_e, d_e = go()
    pos_m, d_m = go(mxu_loop_gradients=True)
    assert d_m.neighbor_drops == 0 and pos_e.shape == pos_m.shape
    assert np.isfinite(pos_m).all()
    assert abs(d_e.density_iterations - d_m.density_iterations) <= 2
    assert abs(d_e.divergence_iterations - d_m.divergence_iterations) <= 4
    np.testing.assert_allclose(pos_e.mean(axis=0), pos_m.mean(axis=0), rtol=0, atol=0.02 * h)
    np.testing.assert_allclose(np.sort(pos_e[:, 1]), np.sort(pos_m[:, 1]), rtol=0,
                               atol=0.25 * h)


# --------------------------------------------------- carries across packages

@pytest.mark.parametrize("kind", list(SOLVERS))
@pytest.mark.parametrize("flag", FLAGS)
def test_cached_carries_cross_the_packages(tmp_path, kind, flag):
    """JAX's carry after 5 flagged contact steps, with its cache: through
    interop and through JAX's checkpoint into the port every leaf bit-equal
    (ctx/grad_dyn included); then 3 more steps of each package agree."""
    _, jc, _, _ = jax_run(kind, flag)
    world, ts, tb = build(1, kind, **{flag: True})
    template = ts.init_carry(noisy_state(1, world), tb)
    names, values, _ = jckpt._paths(jc)
    saved = {n: np.asarray(v) for n, v in zip(names, values)}
    assert "ctx/grad_dyn" in saved
    convert = dfsph_dense_carry_from_numpy if kind == "dense" else dfsph_padded_carry_from_numpy
    converted = convert({n.replace("/", "."): v for n, v in saved.items()}, device="cpu")
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jc)
    loaded = tckpt.load_checkpoint(path, template)

    def bits(a):
        a = np.ascontiguousarray(a)
        return a.view(f"u{a.itemsize}") if a.dtype.kind in "fVi" else a

    for carry in (converted, loaded):
        port = {n: tckpt._to_numpy(v) for n, v in tckpt._leaves(carry)}
        assert sorted(port) == sorted(saved)
        for name, value in saved.items():
            np.testing.assert_array_equal(bits(port[name]), bits(value), err_msg=name)
    if flag == "cache_loop_gradients":  # the port's checkpoint loads into JAX
        tpath = str(tmp_path / "port.npz")
        tckpt.save_checkpoint(tpath, loaded)
        jloaded = jckpt.load_checkpoint(tpath, jc)
        for a, b in zip(jax.tree_util.tree_leaves(jloaded), jax.tree_util.tree_leaves(jc)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    _, js, jb = build(0, kind, **{flag: True})
    jc2, jcounts = run(0, js, jc, jb, 3)
    for carry in (converted, loaded):
        c2, counts = run(1, ts, carry, tb, 3)
        assert counts == jcounts
        np.testing.assert_allclose(sorted_positions(ts, c2), sorted_positions(js, jc2),
                                   rtol=0, atol=1e-5)


# ----------------------------------------------------------------- refusals

REFUSALS = {  # name -> (flags, grid changes, message)
    "cache_bf16": (dict(cache_loop_gradients=True), dict(pair_dtype="bfloat16"),
                   "cache_loop_gradients caches f32"),
    "cache_and_mxu": (dict(cache_loop_gradients=True, mxu_loop_gradients=True), {},
                      "mxu_loop_gradients excludes cache_loop_gradients"),
    "cache_k3": (dict(cache_loop_gradients=True), dict(use_pallas_slotmajor=True),
                 "slot-major route .*excludes"),
    "mxu_k3": (dict(mxu_loop_gradients=True), dict(use_pallas_slotmajor=True),
               "slot-major route .*excludes"),
}


@pytest.mark.parametrize("cls", [TDense, TPadded, TPlane], ids=["dense", "padded", "plane"])
@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals(cls, name):
    """JAX's asserts on the flags (models/dfsph_dense.py:186-205) as
    ValueErrors, on every DFSPH slot solver (the plane solver runs on K3)."""
    flags, grid_changes, message = REFUSALS[name]
    world = contact_scene(TW.FluidParticleWorld)
    grid = dataclasses.replace(world.dense_grid(), **grid_changes)
    if cls is TPlane:  # the plane solver runs on K3 only
        grid = dataclasses.replace(grid, use_pallas_slotmajor=True)
    with pytest.raises(ValueError, match=message):
        cls(viscosity_model=TXSPH(world.properties.smoothing_length),
            properties=world.properties, grid=grid, step_config=TFixed(1.0 / 250.0), **flags)


@pytest.mark.parametrize("kind", ["dfsph_dense_cached", "dfsph_padded_cached",
                                  "dfsph_dense_mxu"])
def test_bench_kinds(kind):
    """scenes.SOLVERS' loop-gradient kinds: the flag on the K5 route, f32."""
    from yasph2d_tpu_torch.scenes import SOLVERS, bench_solver, double_dam_break

    solver, _ = bench_solver(kind, double_dam_break(3_000), device="cpu")
    assert type(solver) is (TDense if "dense" in kind else TPadded)
    assert getattr(solver, SOLVERS[kind].loop_gradients)
    assert not solver.grid.use_pallas_slotmajor and solver.grid.pair_dtype == "float32"


def test_mxu_bf16_grid_runs():
    """The MXU form on a bf16 grid: JAX allows it (its gradients are f32
    pair_map's rounded to bf16; the ctx pass is K5's bf16 math mode), and so
    does the port."""
    world, s, b = build(1, "padded", mxu_loop_gradients=True)
    s = dataclasses.replace(s, grid=dataclasses.replace(s.grid, pair_dtype="bfloat16"))
    c = s.init_carry(noisy_state(1, world), b)
    c, counts = run(1, s, c, b, 2)
    assert all(x[2] == 0 for x in counts) and torch.isfinite(c.v_pad).all()
