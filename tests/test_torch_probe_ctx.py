"""K7, the slot-major ctx-pass probe: the port's plain twin against the JAX
probe's Pallas kernel `ctx_pass_slotmajor` in interpret mode on the CPU, on
the JAX probe's check inputs (run_check: 12 x 40 cells, P 5, h 0.1, m 0.07,
60% mask, seed 0), and against K1's `ctx` form on the same planes.

Tolerances: against the JAX kernel, rtol 1e-5 plus 1e-6 of each output's
largest magnitude: the same statement in the same (dyv, dxv, sp) order, but
XLA contracts multiply-adds and CPU torch.sqrt is not correctly rounded. The
neighbour count is exact. Against K1 `ctx` (the solver's Wendland statement,
another operation order), the probe's own check: rtol 1e-4 plus 1e-5 of the
output's scale."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.probe_pallas_slotmajor import ctx_pass_slotmajor, make_blocks
from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc

torch.set_num_threads(1)


def jax_probe(d, pos, mask, spos=None, smask=None):
    """The JAX probe kernel's output on queries (pos, mask) and sources
    (spos, smask), by default the same, in the port's (5, P, ny, nx)
    layout."""
    q_blocks, s_blocks, _ = make_blocks(jnp.asarray(pos), jnp.asarray(mask), br=4)
    if spos is not None:
        _, s_blocks, _ = make_blocks(jnp.asarray(spos), jnp.asarray(smask), br=4)
    out = jax.jit(functools.partial(ctx_pass_slotmajor, h=d["h"], m=d["m"],
                                    interpret=True))(q_blocks, s_blocks)
    out = np.concatenate([np.asarray(out[i]) for i in range(out.shape[0])], axis=2)
    return out[:, :, :d["ny"], :d["nx"]]


@pytest.fixture(scope="module")
def check_case():
    """The run_check inputs and the JAX kernel's output."""
    d = pc.CHECK_SHAPE
    pos, mask = pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"])
    return d, pos, mask, jax_probe(d, pos, mask)


def test_inputs_are_the_jax_probe_inputs():
    """The numpy generator calls of run_check, in its order."""
    rng = np.random.default_rng(0)
    iy, ix = np.indices((12, 40))
    pos = ((rng.uniform(0, 1, (12, 40, 5, 2)) + np.stack([ix, iy], -1)[:, :, None, :])
           * 0.1).astype(np.float32)
    mask = rng.uniform(size=(12, 40, 5)) < 0.6
    ours = pc.probe_inputs(12, 40, 5, 0.1)
    np.testing.assert_array_equal(ours[0], pos)
    np.testing.assert_array_equal(ours[1], mask)


def check_twin(d, pos, mask, ref, s=None):
    q = pc.probe_planes(pos, mask, "cpu")
    before = dict(pc.LAUNCHES)
    out = pc.ctx_pass(q, q if s is None else s, d["h"], d["m"]).numpy()
    assert pc.LAUNCHES == before  # CPU tensors run the twin
    assert out.shape == ref.shape == (5, d["p"], d["ny"], d["nx"])
    for k in range(4):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(ref[k]).max()), err_msg=k)
    np.testing.assert_array_equal(out[4], ref[4])  # neighbour counts
    live = np.transpose(mask, (2, 0, 1))
    assert (out[:, ~live] == 0).all() and out[4][live].sum() > 0


def test_twin_matches_jax_kernel(check_case):
    check_twin(*check_case)


def test_twin_matches_jax_kernel_twelve_slots():
    """P = 12 query slots (the first CUDA K7 took at most 8) on the check
    shape's cells against a source space of 3 slots (the JAX kernel unrolls
    P x 9 x Ps candidate blocks: 12 x 12 takes its interpret mode too long):
    the twin against the JAX probe kernel."""
    d = dict(pc.CHECK_SHAPE, p=12)
    pos, mask = pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"], seed=4)
    spos, smask = pc.probe_inputs(d["ny"], d["nx"], 3, d["h"], seed=5)
    check_twin(d, pos, mask, jax_probe(d, pos, mask, spos, smask),
               s=pc.probe_planes(spos, smask, "cpu"))


def test_twin_matches_k1_ctx(check_case):
    d, pos, mask, _ = check_case
    q = pc.probe_planes(pos, mask, "cpu")
    out = pc.ctx_pass(q, q, d["h"], d["m"])
    k1 = pc.k1_ctx_call(q, q, d["h"], d["m"])()
    assert pc.agree(out, k1)
    torch.testing.assert_close(out[4], k1[4], rtol=0, atol=0)
    pc.run_check("cpu")  # the entry point's check mode


def test_deeper_source_space():
    """Ps != P: the source planes of another space (3 slots), K7's twin
    against K1 ctx from the same query planes."""
    d = pc.CHECK_SHAPE
    q = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"], seed=1), "cpu")
    s = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], 3, d["h"], seed=2), "cpu")
    out = pc.ctx_pass(q, s, d["h"], d["m"])
    assert out.shape == (5, d["p"], d["ny"], d["nx"]) and float(out[4].sum()) > 0
    assert pc.agree(out, pc.k1_ctx_call(q, s, d["h"], d["m"])())


def test_wrapper_refuses_other_devices():
    q = torch.zeros((3, 9, 2, 2), device="meta")
    with pytest.raises(ValueError):
        pc.ctx_pass(q, q, 0.1, 0.07)
    with pytest.raises(SystemExit):
        pc.run_gpu("cpu")
