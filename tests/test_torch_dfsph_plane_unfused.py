"""The unfused DFSPH plane step (`fuse_loop_elementwise` / `fuse_ctx_elementwise`
False: K1's no-epilogue forms `ctx`, `visc`, `div`, `corr` with the glue in
torch) against the JAX plane solver with the same switches (its pf kernels in
interpret mode, jitted), on the contact scene of
tests/test_torch_dfsph_plane.py with its seeded 3 m/s velocities, so that
both pressure loops iterate and warm-start.

- Each switch off alone and both off: from the same converted carry,
  per-step iteration and drop counts equal to JAX's and the live rows to
  the tolerance of tests/test_torch_dfsph_plane.py (rtol 1e-5, atol 1e-6:
  the same f32 operations in the same order, XLA contracting some
  multiply-adds that PyTorch rounds apart).
- The port's unfused steps against its fused step: live rows bit for bit
  (the glue is the epilogues' operations, one torch operation each, as JAX
  pins for its own switches in tests/test_pallas_plane.py:136-200); dead
  slots are not compared (they hold what the glue makes of the kernels'
  zeros, which nothing reads).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_dfsph_plane import carry_leaves, contact_scene, live_rows
from yasph2d_tpu.models.dfsph_plane import DFSPHPlaneSolver as JSolver
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.timemanager import FixedTimeStep as JFixed
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models import dfsph_plane
from yasph2d_tpu_torch.models.dfsph_plane import DFSPHPlaneSolver as TSolver
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.ops import pair_reduce as tpr
from yasph2d_tpu_torch.timemanager import FixedTimeStep as TFixed
from yasph2d_tpu_torch.utils.interop import boundary_from_numpy, carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

torch.set_num_threads(1)

STEPS = 4
# (fuse_loop_elementwise, fuse_ctx_elementwise)
SWITCHES = [(False, False), (False, True), (True, False)]
IDS = ["both_off", "loop_off", "ctx_off"]


@functools.lru_cache(maxsize=None)
def jax_run(switches):
    """The JAX solver with `switches` on the noisy contact scene: the
    converted init carry's leaves, the boundary's, per-step counts and the
    sorted live rows after STEPS steps."""
    loop, ctx = switches
    jw = contact_scene(JWorld)
    h = jw.properties.smoothing_length
    jgrid = dataclasses.replace(jw.dense_grid(), use_pallas_slotmajor=True,
                                pallas_sm_row_block=4)
    js = JSolver(viscosity_model=JXSPH(h), properties=jw.properties, grid=jgrid,
                 step_config=JFixed(1.0 / 250.0), fuse_loop_elementwise=loop,
                 fuse_ctx_elementwise=ctx)
    jdense = jw.boundary_dense(jgrid)
    jb = js.boundary_planes(jdense)
    c = jax.jit(js.init_carry)(jw.initial_state(), jb)
    noise = np.random.default_rng(42).normal(0.0, 3.0, c.v.shape).astype(np.float32)
    c = c._replace(v=jax.numpy.asarray(noise * np.asarray(c.ctx.mask)))
    init = carry_leaves(c)
    simulate = jax.jit(js.simulate, static_argnums=2)
    counts = []
    for _ in range(STEPS):
        c, d = simulate(c, jb, 1)
        counts.append((int(d.density_iterations), int(d.divergence_iterations),
                       int(d.neighbor_drops)))
    return (init, {f: np.asarray(getattr(jdense, f)) for f in jdense._fields}, counts,
            live_rows(js.export_state(c)))


def port_run(switches, init, boundary_leaves):
    """The port's solver with `switches` from the converted carry: per-step
    counts and the final state's export."""
    loop, ctx = switches
    tw = contact_scene(TWorld)
    h = tw.properties.smoothing_length
    tgrid = dataclasses.replace(tw.dense_grid(), use_pallas_slotmajor=True)
    ts = TSolver(viscosity_model=TXSPH(h), properties=tw.properties, grid=tgrid,
                 step_config=TFixed(1.0 / 250.0), fuse_loop_elementwise=loop,
                 fuse_ctx_elementwise=ctx)
    carry = carry_from_numpy(init, tgrid, device="cpu")
    boundary = boundary_from_numpy(boundary_leaves, device="cpu")
    counts = []
    for _ in range(STEPS):
        carry, d = ts.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    return counts, ts.export_state(carry)


@pytest.mark.parametrize("switches", SWITCHES, ids=IDS)
def test_unfused_steps_match_jax(switches):
    init, boundary, counts_j, rows_j = jax_run(switches)
    counts_t, state = port_run(switches, init, boundary)
    assert counts_t == counts_j
    assert max(n for n, _, _ in counts_j) > 1 and max(n for _, n, _ in counts_j) > 1
    rows_t = live_rows(state)
    assert rows_t.shape == rows_j.shape == (int(state.alive.sum()), 3)
    np.testing.assert_allclose(rows_t, rows_j, rtol=1e-5, atol=1e-6)


# the K1 forms each step runs, by switches
FORMS = {(True, True): {"ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v"},
         (False, False): {"ctx", "visc", "div", "corr"},
         (False, True): {"ctx", "ctx_post", "visc", "div", "corr"},
         (True, False): {"ctx", "visc_gravity", "err_ki", "delta_ki", "corr_v"}}


@pytest.mark.parametrize("switches", SWITCHES, ids=IDS)
def test_unfused_live_rows_bit_equal_to_fused(switches, monkeypatch):
    """From the same carry, the unfused steps give the fused step's counts and
    live rows (positions, velocities, densities) bit for bit, each through
    its own K1 forms."""
    init, boundary, _, _ = jax_run((False, False))
    seen = set()

    def recording(form, *args, **kw):
        seen.add(form.name)
        return tpr.pair_reduce(form, *args, **kw)

    monkeypatch.setattr(dfsph_plane, "pair_reduce", recording)
    rows = {}
    for s in ((True, True), switches):
        seen.clear()
        counts, state = port_run(s, init, boundary)
        assert seen == FORMS[s], (s, seen)
        rows[s] = (counts, torch.cat([state.positions, state.velocities,
                                      state.densities[:, None]], 1)[state.alive])
    (c_f, r_f), (c_u, r_u) = rows[(True, True)], rows[switches]
    assert c_u == c_f
    assert torch.equal(r_u.view(torch.int32), r_f.view(torch.int32))
