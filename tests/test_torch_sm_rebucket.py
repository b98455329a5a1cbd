"""K4 (slot-major re-bucket): the port's plain twin against the JAX sm_rebucket
(interpret mode on the CPU) — bit-equal on positions, values, mask and drops,
including cell overflow, with the WCSPH (D = 2, 3) and DFSPH (D = 4) payload
widths, through the stacked entry `sm_rebucket` and the parts entry
`sm_rebucket_parts` that the padded steps call — against the K2 twin on the
same state through to_planes, and the slot-layout move codes bit-equal to the
JAX move_codes. The two entries give the same bits for every split of the
payload into parts, and a -0.0 payload comes out +0.0 from both."""

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


def parts_of(values, widths):
    """The (ny, nx, P, D) payload cut into parts of the given widths: width 1
    an (ny, nx, P) part, width C an (ny, nx, P, C) one."""
    parts, k = [], 0
    for c in widths:
        piece = values[..., k:k + c]
        parts.append(piece[..., 0].contiguous() if c == 1 else piece.contiguous())
        k += c
    return tuple(parts)


def stack_parts(parts):
    return torch.cat([v[..., None] if v.ndim == 3 else v for v in parts], dim=-1)


# each JAX case's payload as the padded steps pass it: WCSPH's velocity part,
# DFSPH's velocity, kappa and stiffness
PART_WIDTHS = {"moves": (2,), "dense": (2, 1), "overflow": (2,), "dfsph_payload": (2, 1, 1),
               "dfsph_overflow": (2, 1, 1)}


@pytest.mark.parametrize("name", list(CASES))
def test_sm_rebucket_parts_bit_equal_to_jax(name):
    """The parts entry's CPU route (its twin) against the JAX kernel."""
    jgrid, tgrid, adv, mask, vals = make_case(**CASES[name])
    jpos, jmask, jv, jdrops = jax.jit(
        lambda a, m, v: j_sm_rebucket(a, m, v, jgrid, br=BR, interpret=True)
    )(jnp.asarray(adv), jnp.asarray(mask), jnp.asarray(vals))
    parts = parts_of(torch.as_tensor(vals), PART_WIDTHS[name])
    before = dict(tsr.LAUNCHES)
    tpos, tmask, tparts, tdrops = tsr.sm_rebucket_parts(
        torch.as_tensor(adv), torch.as_tensor(mask), parts, tgrid)
    assert tsr.LAUNCHES == before
    assert [t.shape for t in tparts] == [t.shape for t in parts]
    assert all(t.is_contiguous() for t in tparts)
    assert int(tdrops) == int(jdrops)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(bits(tpos.numpy()), bits(jpos))
    np.testing.assert_array_equal(bits(stack_parts(tparts).numpy()), bits(jv))


# (payload widths, number of values): D = 1, D = 2 as two scalars, D = 4 as
# the DFSPH step's parts, and WCSPH's one (ny, nx, P, 2) velocity part
SPLITS = {"d1": (1,), "d2": (1, 1), "d4": (2, 1, 1), "velocity": (2,)}


@pytest.mark.parametrize("overflow", [False, True], ids=["advect", "overflow"])
@pytest.mark.parametrize("split", list(SPLITS))
def test_parts_entry_equals_stacked_entry(split, overflow):
    widths = SPLITS[split]
    case = dict(seed=11, p=2, fill=0.9, shift=(0.6, 0.6), step=0.05) if overflow \
        else dict(seed=13, p=3, fill=0.4)
    _, tgrid, adv, mask, vals = make_case(**case, d=sum(widths))
    pos, m, v = (torch.as_tensor(a) for a in (adv, mask, vals))
    spos, smask, sv, sdrops = tsr.sm_rebucket(pos, m, v, tgrid)
    ppos, pmask, pparts, pdrops = tsr.sm_rebucket_parts(pos, m, parts_of(v, widths), tgrid)
    assert int(pdrops) == int(sdrops)
    assert (int(sdrops) > 0) == overflow
    np.testing.assert_array_equal(pmask.numpy(), smask.numpy())
    np.testing.assert_array_equal(bits(ppos.numpy()), bits(spos.numpy()))
    np.testing.assert_array_equal(bits(stack_parts(pparts).numpy()), bits(sv.numpy()))
    for got, part in zip(pparts, parts_of(sv, widths)):
        np.testing.assert_array_equal(bits(got.numpy()), bits(part.numpy()))


def test_negative_zero_payload_comes_out_positive():
    """Every live slot's payload is -0.0: both entries write +0.0, as the TPU
    kernel, which adds each hit onto +0.0."""
    _, tgrid, adv, mask, vals = make_case(13, p=3, fill=0.7, d=4)
    pos, m = torch.as_tensor(adv), torch.as_tensor(mask)
    neg = torch.full(vals.shape, -0.0)
    assert torch.signbit(neg).all()
    _, smask, sv, _ = tsr.sm_rebucket(pos, m, neg, tgrid)
    _, pmask, pparts, _ = tsr.sm_rebucket_parts(pos, m, parts_of(neg, (2, 1, 1)), tgrid)
    assert int(smask.sum()) > 0
    assert not torch.signbit(sv).any()
    assert not any(torch.signbit(p).any() for p in pparts)


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
    with pytest.raises(ValueError):
        tsr.sm_rebucket_parts(pos.to("meta"), m.to("meta"), (v.to("meta"),), tgrid)
    with pytest.raises(ValueError):
        tsr.sm_rebucket_parts(pos, m, (), tgrid)


def test_slot_index_limit():
    """The kernel numbers slots in 32 bits: (ny + 2) nx P times the widest
    part (at least 2) must fit, which the 100k shard and the 1M grid do
    (`sm_rebucket_parts` checks it on the CUDA route before it launches)."""
    assert tsr.index_fits(163 + 2, 515, 7, (2, 1, 1))  # a 100k shard of two
    assert tsr.index_fits(1010, 1612, 7, (2, 1, 1))  # the 1M grid
    assert tsr.index_fits(1010, 1612, 7, (8,))
    assert not tsr.index_fits(20_000, 20_000, 7, (1,))
    assert not tsr.index_fits(1010, 1612, 7, (200,))
    ny, nx, p = 1000, 1000, 1100  # (ny + 2) nx P x 2 passes 2^31 - 1
    assert not tsr.index_fits(ny, nx, p, (1,))
    assert tsr.index_fits(ny // 2, nx, p, (1,))
