"""The roofline's counting rules (yasph2d_tpu_torch/tools/roofline.py) on a
small settled double dam-break, in both operand modes: K1's mask reads, live
candidates and valid pairs against a brute-force numpy count over every pair
of live slots, and the live pairs against the count plane of K1's `ctx` form.
Counts are exact integers: they must be equal."""

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.ops.dense_grid import f32_scalar
from yasph2d_tpu_torch.ops.pair_reduce import pair_reduce
from yasph2d_tpu_torch.tools import roofline as rl

torch.set_num_threads(1)


def brute_counts(q, s, radius_sq):
    """(mask reads, live candidates, valid pairs) of one K1 pass by looping
    over every live query slot and every live source slot in numpy; bf16
    geometry adds the cell-centre offset of the source's cell, in f32."""
    _, ny, nx = q.mask.shape
    ps = s.mask.shape[0]

    def live(g):
        p, y, x = np.nonzero(g.mask.numpy())
        pos = g.pos.to(torch.float32).numpy()[:, p, y, x].T  # (n, 2) f32
        return y, x, pos

    qy, qx, qpos = live(q)
    sy, sx, spos = live(s)
    cells = [(min(y + 1, ny - 1) - max(y - 1, 0) + 1) * (min(x + 1, nx - 1) - max(x - 1, 0) + 1)
             for y, x in zip(qy, qx)]
    h = None if q.rebase_cell is None else np.float32(f32_scalar(q.rebase_cell))
    cand = pairs = 0
    for i in range(len(qy)):
        dyc, dxc = sy - qy[i], sx - qx[i]
        near = (np.abs(dyc) <= 1) & (np.abs(dxc) <= 1)
        d = (spos[near] - qpos[i]).astype(np.float32)
        if h is not None:
            off = np.stack([dxc[near], dyc[near]], 1).astype(np.float32) * h
            d = (d + off).astype(np.float32)
        r_sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).astype(np.float32)
        cand += int(near.sum())
        pairs += int(((r_sq <= np.float32(radius_sq)) & (r_sq > np.float32(1e-10))).sum())
    return int(np.sum(cells)) * ps, cand, pairs


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def settled(request):
    """A 2k double dam-break after 4 steps, on the CPU twins."""
    return rl.settle(2_000, 4, request.param, torch.device("cpu"))


def test_counts_match_brute_force(settled):
    _, solver, boundary, carry, diags = settled
    geom = carry.ctx.geom
    assert (geom.rebase_cell is None) == (solver.grid.pair_dtype == "float32")
    for src in (geom, boundary.geom):
        c = rl.pass_counts(geom, src, solver.grid.radius_sq)
        assert (c["mask_reads"], c["candidates"], c["pairs"]) == brute_counts(
            geom, src, solver.grid.radius_sq)
    assert c["candidates"] < c["mask_reads"]


def test_count_plane_and_roofline_block(settled):
    world, solver, boundary, carry, _ = settled
    geom = carry.ctx.geom
    fluid = rl.pass_counts(geom, geom, solver.grid.radius_sq)
    count = pair_reduce(solver._forms.ctx, geom, geom, solver._consts)[4]
    assert float(count.sum()) == fluid["pairs"] > 0
    lines = []
    out = rl.roofline(2_000, 4, solver.grid.pair_dtype, torch.device("cpu"),
                      rates={"test rate": 1e12}, log=lines.append)
    assert out["drops"] == 0 and out["live"] == out["fluid"] == world.num_dynamic_particles
    assert out["finite"] and out["pairs_fluid"] == fluid["pairs"]
    assert out["counts_fluid"] == fluid
    assert set(out["floors"]) == set(rl.DFSPH_FORMS)
    ops = rl.form_ops("ctx_post", fluid["candidates"], fluid["pairs"], out["live"])
    assert out["floors"]["ctx_post"]["ops"] == ops
    assert out["floors"]["ctx_post"]["test rate"] == pytest.approx(ops / 1e12 * 1e3)
    assert any(line.startswith("live pairs/particle") for line in lines)


def test_bound_and_form_ops():
    """bound() takes the larger of bytes / 3.35 TB/s and operations /
    67 TFLOP/s; form_ops counts 5 per candidate plus the form's per-pair and
    per-query operations."""
    assert rl.bound(3.35e9, 0) == (1.0, "bytes")
    assert rl.bound(0, 67e9) == (1.0, "operations")
    assert rl.form_ops("corr_v", 10, 4, 3) == 5 * 10 + 13 * 4 + 8 * 3
    assert rl.form_ops("ctx", 10, 4, 3) == 5 * 10 + 26 * 4


def test_instruction_bound():
    """instruction_bound() takes the slowest of each pipe's instructions over
    its rate a clock per SM (FP32 128, ALU 64) and all of them over the
    dispatch rate (128), on 132 SMs at the clock of the data sheet's 67 TFLOP/s. The
    K6 mix probe's step, one FADD, FSETP and FSEL, is bound by the ALU pipe
    at 2 / 64 clocks per 32 steps: 0.827 ms at the probe's size, where
    counting its three instructions as FP32 operations gave 0.310."""
    clock = rl.SMS * rl.SM_HZ
    assert rl.SM_HZ == pytest.approx(1.9827e9, rel=1e-4)
    assert rl.instruction_bound({"FADD": 128 * clock}) == (pytest.approx(1e3), "fp32 pipe")
    steps = 1_690_624 * 4096
    ms, what = rl.instruction_bound({"FADD": steps, "FSETP": steps, "FSEL": steps})
    assert what == "alu pipe" and ms == pytest.approx(2 * steps / (64 * clock) * 1e3)
    assert ms == pytest.approx(0.8268, rel=1e-3)
    assert rl.bound(0, 3 * steps)[0] == pytest.approx(0.3101, rel=1e-3)
