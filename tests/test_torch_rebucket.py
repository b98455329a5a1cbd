"""K2 (re-bucket): the port's plain twin against the JAX pf_rebucket (interpret
mode on the CPU) — bit-equal on positions, values, mask and drops, including
cell overflow — and the move codes bit-equal to pf_move_codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.pallas_slotmajor import (
    pf_move_codes as j_move_codes,
    pf_rebucket,
    to_planes as j_to_planes,
)
from yasph2d_tpu_torch.ops import rebucket as trb
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.planes import pf_move_codes, to_planes

torch.set_num_threads(1)

BR = 4
H = 0.1


def make_case(seed, ny=11, nx=17, p=3, fill=0.5, shift=(0.0, 0.0), step=0.12,
              borders=False):
    """Random live slots, advected by random sub-cell displacements (some cross
    cell borders, some leave the grid), plus a payload of value planes with a
    -0.0 among them. `borders`: every live slot lands exactly on a cell corner
    of its own or a neighbouring cell (origin + k h, rounded to f32)."""
    rng = np.random.default_rng(seed)
    base = dict(cell_size=H, origin=(-0.05, 0.02), nx=nx, ny=ny, occupancy=p)
    jgrid = JGrid(**base, use_pallas_slotmajor=True, pallas_sm_row_block=BR)
    tgrid = TGrid(**base)
    mask = rng.random((ny, nx, p)) < fill
    cy, cx = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * H + np.asarray(base["origin"])
    pos = cell + rng.random((ny, nx, p, 2)) * H
    disp = (rng.random((ny, nx, p, 2)) - 0.5) * step + np.asarray(shift) * H
    if borders:
        disp = rng.integers(-1, 2, (ny, nx, p, 2)) * H + (cell - pos)
    adv = np.where(mask[..., None], pos + disp, 0.0).astype(np.float32)
    vals = rng.standard_normal((ny, nx, p, 3)).astype(np.float32)
    vals[0, 0, 0, 0] = -0.0
    return jgrid, tgrid, adv, mask, vals


def run_both(jgrid, tgrid, adv, mask, vals):
    ny, nx = tgrid.ny, tgrid.nx
    jvals = jnp.stack([j_to_planes(jnp.asarray(vals[..., k]), jgrid, BR) for k in range(3)])
    jpos, jmask, jv, jdrops = jax.jit(
        lambda a, m, v: pf_rebucket(a, m, v, jgrid, br=BR)
    )(j_to_planes(jnp.asarray(adv), jgrid, BR),
      j_to_planes(jnp.asarray(mask), jgrid, BR).astype(bool), jvals)
    tvals = torch.stack([to_planes(torch.as_tensor(vals[..., k])) for k in range(3)])
    tpos, tmask, tv, tdrops = trb.rebucket_ref(
        to_planes(torch.as_tensor(adv)), to_planes(torch.as_tensor(mask)), tvals, tgrid)
    crop = lambda a: np.ascontiguousarray(np.asarray(a)[..., :ny, :nx])
    return ((crop(jpos), crop(jmask), crop(jv), int(jdrops)),
            (tpos.numpy(), tmask.numpy(), tv.numpy(), int(tdrops)))


CASES = {
    "moves": dict(seed=5),
    "dense": dict(seed=6, p=4, fill=0.8),
    # everything drifts one cell right/up into half-full cells: overflow
    "overflow": dict(seed=7, p=2, fill=0.9, shift=(0.6, 0.6), step=0.05),
    # displacements up to 4 cells: clamped codes, negative and off-grid cells
    "outside": dict(seed=8, fill=0.7, step=0.8),
    # positions exactly on cell borders (the floor's edge)
    "borders": dict(seed=9, fill=0.7, borders=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_rebucket_bit_equal_to_jax(name):
    jgrid, tgrid, adv, mask, vals = make_case(**CASES[name])
    (jpos, jmask, jv, jdrops), (tpos, tmask, tv, tdrops) = run_both(
        jgrid, tgrid, adv, mask, vals)
    assert tdrops == jdrops
    if name == "overflow":
        assert tdrops > 0
    np.testing.assert_array_equal(tmask, jmask)
    # bit patterns, so +0.0 / -0.0 count too
    np.testing.assert_array_equal(tpos.view(np.uint32), jpos.view(np.uint32))
    np.testing.assert_array_equal(tv.view(np.uint32), jv.view(np.uint32))
    assert tmask.sum() + tdrops == mask.sum()


@pytest.mark.parametrize("name", list(CASES))
def test_move_codes_bit_equal(name):
    jgrid, tgrid, adv, mask, _ = make_case(**CASES[name])
    jc = j_move_codes(j_to_planes(jnp.asarray(adv), jgrid, BR),
                      j_to_planes(jnp.asarray(mask), jgrid, BR).astype(bool), jgrid)
    tc = pf_move_codes(to_planes(torch.as_tensor(adv)), to_planes(torch.as_tensor(mask)),
                       tgrid)
    jc = np.asarray(jc)[:, :tgrid.ny, :tgrid.nx]
    np.testing.assert_array_equal(tc.numpy().astype(np.float32), jc)
    assert set(np.unique(tc.numpy())) <= set(range(10))


def test_wrapper_dispatch_is_by_device():
    _, tgrid, adv, mask, vals = make_case(5)
    pos, m = to_planes(torch.as_tensor(adv)), to_planes(torch.as_tensor(mask))
    v = torch.stack([to_planes(torch.as_tensor(vals[..., k])) for k in range(3)])
    before = dict(trb.LAUNCHES)
    for a, b in zip(trb.rebucket(pos, m, v, tgrid), trb.rebucket_ref(pos, m, v, tgrid)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert trb.LAUNCHES == before
    with pytest.raises(ValueError):
        trb.rebucket(pos.to("meta"), m.to("meta"), v.to("meta"), tgrid)


def test_rebucket_planes_cpu_route_splits_the_payload():
    """`rebucket_planes` with separate (L, P, ny, nx) and (P, ny, nx) parts is
    the stacked call, returned in the parts' shapes; on the CPU it is the
    twin and launches nothing."""
    _, tgrid, adv, mask, vals = make_case(6, p=4, fill=0.8)
    pos, m = to_planes(torch.as_tensor(adv)), to_planes(torch.as_tensor(mask))
    v = torch.stack([to_planes(torch.as_tensor(vals[..., k])) for k in range(3)])
    before = dict(trb.LAUNCHES)
    new_pos, new_mask, (pair, last), drops = trb.rebucket_planes(pos, m, (v[:2], v[2]), tgrid)
    ref = trb.rebucket_ref(pos, m, v, tgrid)
    assert trb.LAUNCHES == before
    assert pair.shape == v[:2].shape and last.shape == v[2].shape
    for a, b in zip((new_pos, new_mask, torch.cat([pair, last[None]]), drops), ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(new_mask.sum()) + int(drops) == int(m.sum())


def test_shared_memory_of_a_block():
    """K2's block holds P int32 hits per target cell and the move codes of its
    haloed tile, one byte per slot."""
    threads, halo = trb.RB_TY * trb.RB_TX, (trb.RB_TY + 2) * (trb.RB_TX + 2)
    assert trb.smem_bytes(7) == 7 * threads * 4 + 7 * halo
    assert trb.smem_bytes(1) < trb.smem_bytes(7)


def test_launch_refusals():
    """K2's two refusals, raised before a launch: more than six value planes,
    and an occupancy whose block needs more shared memory than the card's
    (P = 171 and up: 1,364 bytes a slot). No config path reaches them: its
    payloads are at most four planes (DFSPH [v(2), kappa, stiffness]) and its
    default dense_occupancy is 8."""
    from yasph2d_tpu_torch.config import SolverConfig

    trb.check_launch(6, 8)
    with pytest.raises(ValueError, match="7 value planes; the kernel takes at most 6"):
        trb.check_launch(7, 8)
    trb.check_launch(4, 170)
    assert trb.smem_bytes(170) <= trb.cuda_build.SMEM_LIMIT < trb.smem_bytes(171)
    with pytest.raises(ValueError, match="occupancy 171 needs 233244 bytes"):
        trb.check_launch(4, 171)
    trb.check_launch(4, SolverConfig().dense_occupancy)
