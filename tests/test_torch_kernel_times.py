"""tools/kernel_times.py's shard cut (`--shard K`) on the CPU: each call of a
padded step on shard K's rows of a one-device state, the source's rows -1
and ny as its halo, gives through the same wrappers (here their twins) the
one-device call's rows; K4's halo form on the cut gives the one-device
re-bucket's rows, and the two shards' drops add up to its drops. On the card
the same cut times K5's and K4's halo forms. `--compare` tells two trees'
`--save` files apart by their bits."""

import argparse
from pathlib import Path

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.ops.pallas_pair import pallas_pair_reduce, rebase_of
from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
from yasph2d_tpu_torch.tools import kernel_times as kt

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]


def _state(kind, steps=3):
    world = double_dam_break(3000)
    solver, boundary = bench_solver(kind, world, device=CPU, ny_multiple=2)
    carry = solver.init_carry(world.initial_state(device=CPU), boundary)
    carry, _ = solver.simulate(carry, boundary, steps)
    return solver, boundary, carry


@pytest.mark.parametrize("kind", ["dfsph_padded_k5", "dfsph_padded_k5_bf16", "wcsph_padded_k5"])
def test_shard_cut_gives_the_one_device_rows(kind):
    solver, boundary, carry = _state(kind)
    ny = solver.grid.ny
    assert ny % 2 == 0
    calls = kt.padded_calls(solver, boundary, carry, np.random.default_rng(0))
    rebucket = kt.padded_rebucket(solver, carry)()
    drops = 0
    for k in (0, 1):
        r0, r1 = k * ny // 2, (k + 1) * ny // 2
        for label, call in calls.items():
            form, q, s, kw = call
            full = pallas_pair_reduce(form, *q, *s, solver._consts,
                                      rebase=rebase_of(solver.grid), **kw)
            form, q, s, kw = kt.shard_call(call, r0, r1, ny)
            assert kw["halo"].row0 == r0 and kw["halo"].ny_total == ny
            out = pallas_pair_reduce(form, *q, *s, solver._consts,
                                     rebase=rebase_of(solver.grid, r0), **kw)
            ref = full[r0:r1]
            torch.testing.assert_close(out, ref, rtol=1e-6,
                                       atol=1e-6 * max(1.0, float(ref.abs().max())))
            if label not in ("stat", "wcsph_stat"):  # the walls see no fluid yet
                assert float(full.abs().sum()) > 0, label
        halo_form, alone = kt.shard_rebucket(solver, carry, r0, r1)
        out = halo_form()
        assert alone()[0].shape == out[0].shape
        for a, b in zip((out[0], out[1], *out[2]), (rebucket[0], rebucket[1], *rebucket[2])):
            assert torch.equal(a, b[r0:r1])
        drops += int(out[3])
    assert drops == int(rebucket[3])


def test_shard_runs_and_their_refusal():
    """`--shard` builds the kind on an even row count and times the halo
    forms on the shard's rows; a plane kind has none and is refused."""
    args = argparse.Namespace(particles=3000, steps=2, shard=1)
    runs, state, per_step, glue, gated = kt.kind_runs("dfsph_padded_k5", args, CPU)
    assert set(runs) == {"ctx", "stat", "div", "corr", "visc", "sm_rebucket",
                         "sm_rebucket_rows_alone"}
    assert len(per_step) == 2 and state[0].shape[0] == state[1].shape[0]
    assert glue == {} and gated == {}
    out = runs["sm_rebucket"]()
    assert out[0].shape == state[0].shape
    assert runs["ctx"]().shape[:3] == state[1].shape
    with pytest.raises(SystemExit, match="padded kind"):
        kt.kind_runs("dfsph_plane", args, CPU)


def test_compare_tells_saves_apart_by_their_bits(tmp_path, capsys):
    """`--compare` passes two saves with the same bits and fails one whose
    call differs in a single bit, or in -0.0 against +0.0."""
    out = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    state = (out.clone(), torch.ones(3, dtype=torch.bool))
    save = {"k": {"state": state, "outputs": {"ctx": out, "rb": (out, torch.tensor(3))}}}
    torch.save(save, tmp_path / "a.pt")
    torch.save(save, tmp_path / "b.pt")
    assert kt.compare(tmp_path / "a.pt", tmp_path / "b.pt")
    for changed in (out.view(torch.int32) ^ 1, torch.where(out == 0, -0.0, out)):
        bad = {"k": {"state": state, "outputs": {"ctx": changed.view(torch.float32)
                                                 if changed.dtype == torch.int32 else changed,
                                                 "rb": (out, torch.tensor(3))}}}
        torch.save(bad, tmp_path / "c.pt")
        assert not kt.compare(tmp_path / "a.pt", tmp_path / "c.pt")
    assert "ctx:DIFFERS" in capsys.readouterr().out
    with pytest.raises(SystemExit) as stop:
        kt.main(["--compare", str(tmp_path / "a.pt"), str(tmp_path / "b.pt")])
    assert stop.value.code == 0


def test_glue_records_of_the_padded_wcsph_kinds():
    """A padded WCSPH kind times its four glue calls apart from its pair
    calls and K4 (not saved), each with its byte bound, whether it gives its
    twin's bits and its launches a step (none on CPU tensors, where the call
    is the twin)."""
    args = argparse.Namespace(particles=3000, steps=2, shard=None)
    runs, state, per_step, glue, gated = kt.kind_runs("wcsph_padded_k5", args, CPU)
    names = ["slot_kick_drift", "slot_density_tait", "slot_accel_cfl", "slot_kick"]
    assert list(glue) == names and not set(names) & set(runs) and gated == {}
    n = state[1].numel()
    for name, r in glue.items():
        assert r["bit_equal"] and r["launches_per_step"] == 0.0
        assert n < r["bytes"] and r["bound_ms"] > 0
        r["kernel"]()
        r["twin"]()


def test_glue_records_of_the_padded_dfsph_kinds():
    """A padded DFSPH kind times the pressure loops' glue calls (both loops'
    error and the kick) apart from its pair calls and K4, each with its byte
    bound, whether it gives its twin's bits and its launches a step (none on
    CPU tensors), and an iteration's four loop launches gated off;
    `--config`
    gives the solver the configuration's loop knobs and CFL."""
    config = ROOT / "portbench/configs/dfsph_converged_f32.json"
    args = argparse.Namespace(particles=1000, steps=2, shard=None, config=str(config))
    runs, state, per_step, glue, gated = kt.kind_runs("dfsph_padded_k5", args, CPU)
    assert list(gated) == ["gated_div", "gated_corr", "gated_slot_pressure_err",
                           "gated_slot_pressure_kick"]
    for call in gated.values():
        call()
    names = ["slot_pressure_err", "slot_pressure_err_divergence", "slot_pressure_kick"]
    assert list(glue) == names and not set(names) & set(runs)
    n = state[1].numel()
    for name, r in glue.items():
        assert r["bit_equal"] and r["launches_per_step"] == 0.0
        assert n < r["bytes"] and r["bound_ms"] > 0
        r["kernel"]()
        r["twin"]()
    world = double_dam_break(1000)
    solver = kt.configured(bench_solver("dfsph_padded_k5", world, device=CPU)[0], config)
    assert solver.max_avg_density_error == 1e-8 and solver.step_config.cfl_factor == 0.75
