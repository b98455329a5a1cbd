"""The port's frame-loop governor (yasph2d_tpu_torch/timemanager.py TimeManager)
against the JAX package's, on the host.

Both governors run the same script: frame deltas forced
(`force_frame_delta`) or read from a scripted wall clock (`time.perf_counter`
monkeypatched in both modules, `on_frame_presented`), and after every
PERFORM_STEP_AND_CALL_AGAIN a "solver step" that sets the next dt of a seeded
sequence, as a step's CFL update does. They must give the same decision
sequence, step and frame counts, accepted lag and the same float32 simulated
time. The cases of tests/test_timemanager.py:78-130 (caught up, dropping with
the 90% lag acceptance, restart) and the R-key retarget
(`with_target_frame_length`) are mirrored on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import yasph2d_tpu.timemanager as J
import yasph2d_tpu_torch.timemanager as T


class Clock:
    """A scripted `time.perf_counter`: each call returns the next time."""

    def __init__(self, times):
        self.times = list(times)

    def __call__(self):
        return self.times.pop(0)


def set_dt(mod, state, dt):
    return state._replace(dt=jnp.float32(dt) if mod is J else np.float32(dt))


def drive(mod, step_config, budget, frames, dts, monkeypatch, clock_times):
    """Run the governor through `frames` (each a forced delta, or None for a
    wall-clock frame); returns everything it decided and counted."""
    monkeypatch.setattr(mod.time, "perf_counter", Clock(clock_times))
    tm = mod.TimeManager(mod.TimerConfig(step_config, budget))
    dts = list(dts)
    trace = []
    for delta in frames:
        if delta is not None:
            tm.force_frame_delta(delta)
        while True:
            r = tm.simulation_frame_loop()
            trace.append(r.name)
            if r != mod.SimulationStepResult.PERFORM_STEP_AND_CALL_AGAIN:
                break
            tm.time_state = set_dt(mod, tm.time_state, dts.pop(0))
        trace.append(("frame", tm.num_simulation_steps_this_frame,
                      tm.simulated_time_this_frame))
        tm.on_frame_presented(1.0)
    return dict(
        trace=trace,
        steps=tm.num_simulation_steps,
        frames=tm.num_frames_rendered,
        lag=tm.accepted_simulation_to_render_lag,
        total=np.float32(tm.time_state.total_simulated_time),
        rendered=tm.total_rendered_time,
        history=list(tm.frame_duration_history),
    )


def scripted(seed, n_frames):
    rng = np.random.default_rng(seed)
    frames = [float(d) if rng.random() < 0.5 else None
              for d in rng.uniform(1.0 / 240.0, 1.0 / 15.0, n_frames)]
    dts = np.float32(rng.uniform(1e-3, 1e-2, 10_000))
    # wall clock: restart, then one reading per presented frame
    clock = np.cumsum(np.concatenate([[100.0], rng.uniform(1.0 / 240.0, 0.2, n_frames)]))
    return frames, dts, [float(t) for t in clock]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("budget", [1.0 / 30.0, 0.005])
def test_frame_loop_matches_jax(seed, budget, monkeypatch):
    frames, dts, clock = scripted(seed, 40)
    step_config = T.AdaptiveTimeStep(1.0 / 360.0, 1.0 / 24000.0, 1.5, 1.0 / 60.0)
    j_config = J.AdaptiveTimeStep(1.0 / 360.0, 1.0 / 24000.0, 1.5, 1.0 / 60.0)
    ref = drive(J, j_config, budget, frames, dts, monkeypatch, clock)
    port = drive(T, step_config, budget, frames, dts, monkeypatch, clock)
    assert port["trace"] == ref["trace"]
    assert (port["steps"], port["frames"]) == (ref["steps"], ref["frames"])
    assert port["lag"] == ref["lag"]
    assert port["total"] == ref["total"]  # the same float32
    assert port["rendered"] == ref["rendered"] and port["history"] == ref["history"]
    if budget < 0.01:  # the budget bites: steps were dropped and lag accepted
        assert "DROPPING_SIMULATION_STEPS" in port["trace"] and port["lag"] > 0


def run_until_caught_up(tm, mod):
    results = []
    while True:
        r = tm.simulation_frame_loop()
        results.append(r)
        if r != mod.SimulationStepResult.PERFORM_STEP_AND_CALL_AGAIN:
            return results


@pytest.mark.parametrize("mod", [J, T], ids=["jax", "port"])
def test_frame_loop_steps_until_caught_up(mod):
    """tests/test_timemanager.py:78-99: 0.035 s forced, 10 ms fixed steps ->
    7 steps to the predicted render time 0.07 s."""
    tm = mod.TimeManager(mod.TimerConfig(mod.FixedTimeStep(0.01), 1.0))
    tm.force_frame_delta(0.035)
    results = run_until_caught_up(tm, mod)
    perform = mod.SimulationStepResult.PERFORM_STEP_AND_CALL_AGAIN
    assert results == [perform] * 7 + [mod.SimulationStepResult.CAUGHT_UP_WITH_RENDER_TIME]
    assert abs(tm.total_simulated_time - 0.07) < 1e-6
    assert tm.num_simulation_steps == 7


def test_frame_loop_drops_steps_and_accepts_lag():
    """tests/test_timemanager.py:102-116 on both: a 0.02 s budget at 10 ms steps
    runs 3 steps, then accepts 90% of the remaining lag, the same in both."""
    lags = []
    for mod in (J, T):
        tm = mod.TimeManager(mod.TimerConfig(mod.FixedTimeStep(0.01), 0.02))
        tm.force_frame_delta(1.0)
        results = run_until_caught_up(tm, mod)
        assert len(results) == 4
        assert results[-1] == mod.SimulationStepResult.DROPPING_SIMULATION_STEPS
        lags.append(tm.accepted_simulation_to_render_lag)
    assert lags[1] == lags[0] and lags[1] > 0.8
    # the next frame's budget starts from the accepted lag
    tm.skip_simulation_frame()
    assert tm.accepted_simulation_to_render_lag == lags[1] + tm.frame_delta()


def test_restart_resets_clock():
    """tests/test_timemanager.py:119-129."""
    tm = T.TimeManager(T.TimerConfig(T.FixedTimeStep(0.01), 1.0))
    tm.force_frame_delta(0.05)
    run_until_caught_up(tm, T)
    assert tm.num_simulation_steps > 0
    tm.restart()
    assert tm.num_simulation_steps == 0
    assert tm.total_simulated_time == 0.0
    assert tm.time_state == T.TimeState.initial(tm.config.step_config)


def test_retarget_matches_jax():
    """The R-key retarget: `with_target_frame_length` sets or clears the
    recording target on the host clock (an np.float32), and the dt policy
    then takes the reference's TargetFrameLength lower bound, as the JAX
    state's (tests/test_timemanager.py:130-157)."""
    j_cfg = J.AdaptiveTimeStep(timestep_max=0.01, timestep_min=0.004, cfl_factor=1.0)
    t_cfg = T.AdaptiveTimeStep(timestep_max=0.01, timestep_min=0.004, cfl_factor=1.0)
    total = 3 * (1.0 / 60.0) + 0.001
    j_base = J.TimeState.initial(j_cfg)._replace(
        dt=jnp.float32(0.01), total_simulated_time=jnp.float32(total))
    t_base = T.TimeState.initial(t_cfg)._replace(
        dt=np.float32(0.01), total_simulated_time=np.float32(total))
    for target in (None, 1.0 / 60.0, 1.0 / 30.0):
        js = j_base.with_target_frame_length(target)
        ts = t_base.with_target_frame_length(target)
        assert type(ts.target_frame_length) is np.float32
        assert ts.target_frame_length == np.float32(js.target_frame_length)
        jd = J.update_simulation_step(j_cfg, js, 0.0001, jnp.float32(100.0)).dt
        td = T.update_simulation_step(t_cfg, ts, 0.0001, np.float32(100.0)).dt
        assert td == np.float32(jd)
    # set then cleared: the plain lower bound again
    cleared = t_base.with_target_frame_length(1.0 / 60.0).with_target_frame_length(None)
    assert cleared.target_frame_length == 0.0
    assert abs(float(T.update_simulation_step(t_cfg, cleared, 0.0001, 100.0).dt)
               - 0.004) < 1e-6
