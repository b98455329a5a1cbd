"""K4 (slot-major re-bucket): the port's plain twin against the JAX sm_rebucket
(interpret mode on the CPU) — bit-equal on positions, values, mask and drops,
including cell overflow, with the WCSPH (D = 2, 3) and DFSPH (D = 4) payload
widths — against the K2 twin on the same state through
to_planes, and the slot-layout move codes bit-equal to the JAX move_codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.ops.dense_grid import DenseGridConfig as JGrid
from yasph2d_tpu.ops.dense_grid import move_codes as j_move_codes
from yasph2d_tpu.ops.pallas_slotmajor import sm_rebucket as j_sm_rebucket
from yasph2d_tpu_torch.ops import rebucket as trb
from yasph2d_tpu_torch.ops import sm_rebucket as tsr
from yasph2d_tpu_torch.ops.dense_grid import DenseGridConfig as TGrid
from yasph2d_tpu_torch.ops.dense_grid import move_codes
from yasph2d_tpu_torch.ops.planes import from_planes, to_planes

torch.set_num_threads(1)

BR = 4
H = 0.1
NY, NX = 9, 7


def make_case(seed, p=3, fill=0.5, shift=(0.0, 0.0), step=0.12, d=2):
    """Random live slots, advected by random sub-cell displacements (some cross
    cell borders, some leave the grid), plus a payload of D values with a -0.0
    among them."""
    rng = np.random.default_rng(seed)
    base = dict(cell_size=H, origin=(-0.05, 0.02), nx=NX, ny=NY, occupancy=p)
    jgrid = JGrid(**base, use_pallas_slotmajor=True, pallas_sm_row_block=BR)
    tgrid = TGrid(**base)
    mask = rng.random((NY, NX, p)) < fill
    cy, cx = np.meshgrid(np.arange(NY), np.arange(NX), indexing="ij")
    cell = np.stack([cx, cy], axis=-1)[:, :, None, :] * H + np.asarray(base["origin"])
    pos = cell + rng.random((NY, NX, p, 2)) * H
    disp = (rng.random((NY, NX, p, 2)) - 0.5) * step + np.asarray(shift) * H
    adv = np.where(mask[..., None], pos + disp, 0.0).astype(np.float32)
    vals = rng.standard_normal((NY, NX, p, d)).astype(np.float32)
    vals[0, 0, 0, 0] = -0.0
    return jgrid, tgrid, adv, mask, vals


CASES = {
    "moves": dict(seed=5),
    "dense": dict(seed=6, p=3, fill=0.8, d=3),
    # everything drifts one cell right/up into half-full cells: overflow
    "overflow": dict(seed=7, p=2, fill=0.9, shift=(0.6, 0.6), step=0.05),
    # the DFSPH padded step's payload [v*(2) | kappa | stiffness], D = 4
    "dfsph_payload": dict(seed=8, p=3, fill=0.6, d=4),
    "dfsph_overflow": dict(seed=9, p=2, fill=0.9, shift=(0.6, 0.6), step=0.05, d=4),
}


def bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(CASES))
def test_sm_rebucket_bit_equal_to_jax(name):
    jgrid, tgrid, adv, mask, vals = make_case(**CASES[name])
    jpos, jmask, jv, jdrops = jax.jit(
        lambda a, m, v: j_sm_rebucket(a, m, v, jgrid, br=BR, interpret=True)
    )(jnp.asarray(adv), jnp.asarray(mask), jnp.asarray(vals))
    tpos, tmask, tv, tdrops = tsr.sm_rebucket_ref(
        torch.as_tensor(adv), torch.as_tensor(mask), torch.as_tensor(vals), tgrid)
    assert int(tdrops) == int(jdrops)
    if name.endswith("overflow"):
        assert int(tdrops) > 0
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    # bit patterns, so +0.0 / -0.0 count too
    np.testing.assert_array_equal(bits(tpos.numpy()), bits(jpos))
    np.testing.assert_array_equal(bits(tv.numpy()), bits(jv))
    assert int(tmask.sum()) + int(tdrops) == mask.sum()


@pytest.mark.parametrize("name", list(CASES))
def test_sm_twin_equals_plane_twin(name):
    """K4's twin and K2's twin on the same state, through to_planes."""
    _, tgrid, adv, mask, vals = make_case(**CASES[name])
    pos, m, v = (torch.as_tensor(a) for a in (adv, mask, vals))
    spos, smask, sv, sdrops = tsr.sm_rebucket_ref(pos, m, v, tgrid)
    planes = torch.stack([to_planes(v[..., k]) for k in range(v.shape[-1])])
    ppos, pmask, pv, pdrops = trb.rebucket_ref(to_planes(pos), to_planes(m), planes,
                                               tgrid)
    assert int(sdrops) == int(pdrops)
    np.testing.assert_array_equal(from_planes(pmask).numpy(), smask.numpy())
    np.testing.assert_array_equal(bits(from_planes(ppos).numpy()), bits(spos.numpy()))
    np.testing.assert_array_equal(
        bits(torch.stack([from_planes(pv[k]) for k in range(pv.shape[0])], -1).numpy()),
        bits(sv.numpy()))


@pytest.mark.parametrize("name", list(CASES))
def test_move_codes_bit_equal(name):
    jgrid, tgrid, adv, mask, _ = make_case(**CASES[name])
    jc = np.asarray(j_move_codes(jnp.asarray(adv), jnp.asarray(mask), jgrid))
    tc = move_codes(torch.as_tensor(adv), torch.as_tensor(mask), tgrid)
    np.testing.assert_array_equal(tc.numpy().astype(np.int32), jc)
    assert set(np.unique(tc.numpy())) <= set(range(10))


def test_wrapper_dispatch_is_by_device():
    _, tgrid, adv, mask, vals = make_case(5)
    pos, m, v = (torch.as_tensor(a) for a in (adv, mask, vals))
    before = dict(tsr.LAUNCHES)
    for a, b in zip(tsr.sm_rebucket(pos, m, v, tgrid), tsr.sm_rebucket_ref(pos, m, v, tgrid)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tsr.LAUNCHES == before
    with pytest.raises(ValueError):
        tsr.sm_rebucket(pos.to("meta"), m.to("meta"), v.to("meta"), tgrid)
