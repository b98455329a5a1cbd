"""The benchmark's cell on upstream's own dam-break, `wcsph_refscene_1m`
(configuration `wcsph_scaled_dtmin_f32`: `wcsph_f32` with upstream's dt
floor scaled to the particle size), on the CPU, and the counter that says
which bound set each step's dt (timemanager.py `CLAMPS`).

- The cell run whole through `portbench.harness.run_cell` at ~1000
  particles, its compared steps straddling the fluid's first contact with
  the ramp (step 50 at this size): the program is `correct`, the control
  (the program's bf16 pair math) is not. The two runs take ~80 s on the
  CPU. Every step of the program's run counts one bound in `CLAMPS`, and
  none the floor.
- `CLAMPS` counts the floor, the ceiling and the CFL dt on hand-built time
  states, whose dt stays the JAX package's bit for bit.
- The floor-scaled run of `wcsph_f32` (`slow`): upstream's floor of 1/24000
  s times d(2k) / d(1M), so that it binds at the same multiple of d / v as
  at 1M, where the run blows up at the ramp impact. The port steps from the
  eager JAX solver's carry at every step through the ramp contact with dt
  on the floor, and gives JAX's drops, dt and live slots.
"""

import json
import math
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import yasph2d_tpu.timemanager as J
import yasph2d_tpu_torch.timemanager as T
from yasph2d_tpu.models.viscosity import XSPHViscosityModel as JXSPH
from yasph2d_tpu.models.wcsph_dense import WCSPHPaddedSolver as JSolver
from yasph2d_tpu.world import FluidParticleWorld as JWorld
from yasph2d_tpu_torch.models.viscosity import XSPHViscosityModel as TXSPH
from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedSolver as TSolver
from yasph2d_tpu_torch.utils.interop import wcsph_padded_carry_from_numpy
from yasph2d_tpu_torch.world import FluidParticleWorld as TWorld

from portbench import harness

ROOT = Path(__file__).resolve().parents[1]
SCENE = json.loads((ROOT / "portbench/scenes/reference_dam_break.json").read_text())
KNOBS = ("boundary_force_factor", "target_density_variation", "expected_max_flow_speed")
OCCUPANCY = 8  # the cell's slots a cell


CELL = "wcsph_refscene_1m"
SEED = 2**31 + 7
# the fluid first meets the ramp at step 50 at ~1000 particles: settle to
# two steps before it, so that each draw of the 3 compared steps of the
# 4-step segment holds the step before the contact and the contact
CONTACT = 50
SIZE = {"target_particles": 1000, "settle_steps": CONTACT - 2, "segment_steps": 4}


def config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def small_run(pair_dtype=None):
    """The result line, for every step in the order run the fluid in
    contact with the ramp or a wall (a boundary particle within h), and
    the steps by the bound that set their dt (`CLAMPS`)."""
    contact = []
    T.CLAMPS.clear()

    def wrapper(step):
        def run(system, carry):
            carry, rec = step(system, carry)
            b = system.boundary
            h = system.solver.properties.smoothing_length
            near = torch.cdist(carry.pos_pad[carry.mask], b.pos_pad[b.mask]) <= h
            contact.append(int(near.any(dim=1).sum()))
            return carry, rec
        return run

    res = harness.run_cell(ROOT, CELL, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter(), pair_dtype=pair_dtype, step_wrapper=wrapper,
                           size=SIZE, log=lambda *a: None)
    return res, contact, dict(T.CLAMPS)


@pytest.fixture(scope="module")
def program_run():
    return small_run()


def compared(rows):
    """The rows of the compared steps: the harness keeps 3 consecutive steps
    of the window's first replay, from a start drawn from the seed."""
    settle, segment, n = SIZE["settle_steps"], SIZE["segment_steps"], 3
    first = int(np.random.default_rng(SEED % 2**64).integers(0, segment - n + 1))
    replay = rows[settle + segment:settle + 2 * segment]  # after the warm-up replay
    return replay[first:first + n]


def test_program_is_correct_through_the_ramp_contact(program_run):
    res, contact, _ = program_run
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    # the settle ends before the fluid meets the ramp (the fluid that began
    # within h of the left wall's inner layers has left it), and the compared
    # steps run into the contact
    assert contact[SIZE["settle_steps"] - 1] == 0
    steps = compared(contact)
    assert steps[0] == 0 < steps[-1], steps
    assert {"particle_steps_per_s", "step_ms_p95", "setup_s"} == set(res["metrics"])


def test_control_is_not_correct():
    res, _, _ = small_run(pair_dtype="bfloat16")
    assert res["correct"] is False, res["checks"]


def test_the_configuration_departs_from_wcsph_f32_in_its_floor_alone():
    scaled, base = config("wcsph_scaled_dtmin_f32"), config("wcsph_f32")
    assert scaled["timestep"]["timestep_min"] == pytest.approx(1.0 / 240000.0, rel=1e-15)
    assert scaled["timestep"]["timestep_min"] == pytest.approx(
        base["timestep"]["timestep_min"] / 10.0, rel=1e-15)
    for key in ("method", "adapter", "solver", "viscosity", "gravity"):
        assert scaled[key] == base[key], key
    assert ({k: v for k, v in scaled["timestep"].items() if k != "timestep_min"}
            == {k: v for k, v in base["timestep"].items() if k != "timestep_min"})


def test_no_step_of_the_cell_sits_on_the_floor(program_run):
    """The settle, the warm-up and the window's replays: each step's dt is
    set by one bound, and never by the floor."""
    _, contact, clamps = program_run
    assert sum(clamps.values()) == len(contact) > 2 * SIZE["segment_steps"], clamps
    assert clamps.get("floor", 0) == 0, clamps


# (previous dt, fastest particle) -> the bound that sets the next dt, at
# upstream's WCSPH settings (CFL 0.2 in [1/24000, 1/360] s) and d = 1 cm:
# the CFL dt is 8e-4 s / (|v| + 1e-5)
BOUNDS = {
    "cfl": (1e-3, 1.0),  # 8.0e-4 s, within [4.2e-5, 2e-3]
    "ceiling": (1e-4, 0.01),  # 0.08 s, above twice the previous dt
    "floor": (1e-3, 100.0),  # 8.0e-6 s, under 1/24000 s
    "cfl_nan": (1e-3, float("nan")),  # a NaN dt stays the CFL's
}


@pytest.mark.parametrize("case", list(BOUNDS))
def test_clamps_count_the_bound_that_set_dt(case):
    dt, speed = BOUNDS[case]
    args = (1.0 / 360.0, 1.0 / 24000.0, 0.2)
    T.CLAMPS.clear()
    ours = T.update_simulation_step(T.AdaptiveTimeStep(*args),
                                    T.TimeState.initial(T.AdaptiveTimeStep(*args))._replace(
                                        dt=np.float32(dt)).account_step(), 0.01, speed)
    assert dict(T.CLAMPS) == {case.split("_")[0]: 1}
    ref = J.update_simulation_step(J.AdaptiveTimeStep(*args),
                                   J.TimeState.initial(J.AdaptiveTimeStep(*args))._replace(
                                       dt=jax.numpy.float32(dt)).account_step(), 0.01,
                                   jax.numpy.float32(speed))
    np.testing.assert_array_equal(np.float32(ours.dt), np.asarray(ref.dt, dtype=np.float32))


def test_clamps_count_steps_not_fixed_steps():
    T.CLAMPS.clear()
    state = T.TimeState.initial(T.FixedTimeStep(1e-3)).account_step()
    assert T.update_simulation_step(T.FixedTimeStep(1e-3), state, 0.01, 100.0).dt == np.float32(
        1e-3)
    assert not T.CLAMPS


# the floor-scaled run of wcsph_f32 at ~2k particles: its floor binds from
# step 75 (the fastest particle passes 1.22 m/s, as at 1M from step ~1500),
# the fluid first meets the ramp at step 88; the jitted JAX solver runs the
# steps before the window, the eager one the window
FLOOR_PARTICLES = 2000
FLOOR_BEFORE = 70
FLOOR_WINDOW = 30


def reference_world(world_cls, target_particles):
    """The scene of portbench/scenes/reference_dam_break.json, unjittered
    by a seed: upstream's fluid lattice, in its own order."""
    area = sum(r["rect"][2] * r["rect"][3] for r in SCENE["fluid_rects"])
    world = world_cls(SCENE["smoothing_factor"], target_particles / (area * 0.81),
                      SCENE["fluid_density"])
    for r in SCENE["fluid_rects"]:
        world.add_fluid_rect(tuple(r["rect"]), r["jitter"])
    for b in SCENE["boundary_thick_lines"]:
        world.add_boundary_thick_line(tuple(b["start"]), tuple(b["end"]), b["thickness"])
    return world


def leaves(carry) -> dict:
    out = {f: np.asarray(getattr(carry, f)) for f in carry._fields if f != "time"}
    out.update({f"time.{f}": np.asarray(getattr(carry.time, f)) for f in carry.time._fields})
    return out


def contacts(pos, boundary, h) -> int:
    """Fluid particles with a boundary particle within h."""
    d2 = ((pos[:, None, :] - boundary[None, :, :]) ** 2).sum(-1)
    return int((d2 <= h * h).any(axis=1).sum())


@pytest.fixture(scope="module")
def floor_steps():
    """Each window step: the eager JAX step and the port's step from the
    JAX carry before it."""
    cfg = config("wcsph_f32")
    t = cfg["timestep"]
    floor = t["timestep_min"] * math.sqrt(1e6 / FLOOR_PARTICLES)  # x d(2k) / d(1M)
    knobs = {k: cfg["solver"][k] for k in KNOBS}
    jw, tw = reference_world(JWorld, FLOOR_PARTICLES), reference_world(TWorld, FLOOR_PARTICLES)
    h = jw.properties.smoothing_length
    eps = cfg["viscosity"]["xsph_epsilon"]
    js = JSolver(viscosity_model=JXSPH(h, eps), properties=jw.properties,
                 grid=jw.dense_grid(occupancy=OCCUPANCY),
                 step_config=J.AdaptiveTimeStep(t["timestep_max"], floor, t["cfl_factor"]),
                 **knobs)
    ts = TSolver(viscosity_model=TXSPH(h, eps), properties=tw.properties,
                 grid=tw.dense_grid(occupancy=OCCUPANCY),
                 step_config=T.AdaptiveTimeStep(t["timestep_max"], floor, t["cfl_factor"]),
                 **knobs)
    assert not ts.grid.use_pallas_slotmajor  # the K5 route, as the cell's
    jb, tb = jw.boundary_dense(js.grid), tw.boundary_dense(ts.grid, device="cpu")
    boundary = np.asarray(jb.pos_pad)[np.asarray(jb.mask)]
    c = jax.jit(js.simulate, static_argnums=2)(js.init_carry(jw.initial_state()), jb,
                                               FLOOR_BEFORE)[0]
    steps = []
    with jax.disable_jit():
        for _ in range(FLOOR_WINDOW):
            before = leaves(c)
            c, d = js.simulate(c, jb, 1)
            carry = wcsph_padded_carry_from_numpy(before, device="cpu")
            T.CLAMPS.clear()
            ours, diag = ts.step(carry._replace(time=carry.time.account_step()), tb)
            ref = leaves(c)
            steps.append(dict(jax=ref, jax_drops=int(d.neighbor_drops), jax_dt=float(d.dt),
                              port=ours, port_drops=int(diag.neighbor_drops),
                              port_dt=float(diag.dt), bound=dict(T.CLAMPS),
                              contacts=contacts(ref["pos_pad"][ref["mask"]], boundary, h)))
    return steps


@pytest.mark.slow
def test_floor_window_holds_the_ramp_contact_on_the_floor(floor_steps):
    assert floor_steps[0]["contacts"] == 0 < floor_steps[-1]["contacts"]
    assert all(s["bound"] == {"floor": 1} for s in floor_steps[10:])


@pytest.mark.slow
def test_port_steps_as_eager_jax_with_the_floor_scaled(floor_steps):
    """Slot for slot (the re-bucket is exact, so the slots hold the same
    particles), to the tolerances of tests/test_torch_wcsph.py's one-step
    check."""
    for k, s in enumerate(floor_steps):
        ref, ours = s["jax"], s["port"]
        assert s["port_drops"] == s["jax_drops"] == 0, k
        assert s["port_dt"] == s["jax_dt"], k
        np.testing.assert_allclose(float(ours.time.dt), float(ref["time.dt"]), rtol=1e-6,
                                   err_msg=str(k))
        mask = ours.mask.numpy()
        np.testing.assert_array_equal(mask, ref["mask"], err_msg=str(k))
        for field in ("pos_pad", "v_pad", "dens_pad"):
            np.testing.assert_allclose(getattr(ours, field).numpy()[mask], ref[field][mask],
                                       rtol=1e-5, atol=1e-6, err_msg=f"{field} {k}")
