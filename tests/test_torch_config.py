"""The configured entry point: the port's SimulationConfig (config.py) against
the JAX package's, its build and its CLI (`python -m yasph2d_tpu_torch`).

- The JSON schema is shared: a file written by either package loads in the
  other, dict-equal; unknown keys are rejected; every SolverConfig field is
  either wired to the port's solvers or one of the named TPU layout knobs.
- Each port kind, with XSPH and with physical viscosity (mu = 0.01, the
  reference's high-viscosity config), builds from a JSON that the JAX package
  wrote, on the scene of tests/test_config.py:18-31, and steps 5 steps on the
  CPU (the kernels' twins). The reference is the JAX package built from the
  same file on its XLA padded route of the same solver family (the contract
  both JAX kernel routes are held to; the jitted JAX plane and slot-major
  solvers compile for minutes in interpret mode). They agree to f32 drift:
  equal per-step iterations and drops, dt to rtol 1e-6, sorted live positions
  to atol 1e-5, densities to rtol 1e-4 / atol 1e-2 (the tolerances of
  tests/test_torch_dfsph_padded.py).
- `rebuild_every = 3` over 7 steps on dfsph_padded (both routes) and
  dfsph_plane against the JAX padded solver's own blocking.
- `python -m yasph2d_tpu_torch run` prints the JAX `run` keys, `dump-config`
  writes a file the JAX package loads, and no module of the port imports JAX.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import yasph2d_tpu.config as J
import yasph2d_tpu_torch.config as T
from yasph2d_tpu_torch.models import dfsph_dense as t_dense
from yasph2d_tpu_torch.models import dfsph_plane as t_plane

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STEPS = 5
# port kind -> (config kind, use_pallas_slotmajor)
PORT_KINDS = {
    "dfsph_padded_k5": ("dfsph_padded", False),
    "dfsph_padded_k3": ("dfsph_padded", True),
    "dfsph_plane": ("dfsph_plane", False),
    "wcsph_padded_k5": ("wcsph_padded", False),
    "wcsph_padded_k3": ("wcsph_padded", True),
    "wcsph_plane": ("wcsph_plane", False),
}


def small_config(mod, kind, visc="xsph", **solver):
    """tests/test_config.py:18-31's scene and fixed step in `mod`'s schema."""
    return mod.SimulationConfig(
        fluid=mod.FluidConfig(particle_density=1600.0),
        viscosity=mod.ViscosityConfig(kind=visc, fluid_viscosity=0.01),
        solver=mod.SolverConfig(kind=kind, **solver),
        timestep=mod.TimestepConfig(kind="fixed", fixed_timestep=1.0 / 3000.0),
        scene=[
            mod.FluidRect(rect=(0.1, 0.7, 0.5, 1.0), jitter=0.05),
            mod.BoundaryThickLine(start=(0.0, 0.0), end=(2.0, 0.0), thickness=4),
            mod.BoundaryThickLine(start=(0.0, 0.0), end=(0.0, 2.5), thickness=4),
            mod.BoundaryThickLine(start=(2.0, 0.0), end=(2.0, 2.5), thickness=4),
            mod.BoundaryThickLine(start=(-2.0, -0.5), end=(4.0, -0.5), thickness=4),
        ],
    )


def live_rows(solver, carry) -> np.ndarray:
    """(x, y, density) of the live particles, sorted by position."""
    s = solver.export_state(carry)
    alive = np.asarray(s.alive)
    rows = np.concatenate([np.asarray(s.positions)[alive],
                           np.asarray(s.densities)[alive][:, None]], axis=1)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


def counts(diag):
    return (int(diag.density_iterations), int(diag.divergence_iterations),
            int(diag.neighbor_drops))


_JAX_RUNS = {}


def jax_reference(path, steps, per_step):
    """The JAX package built from the JSON at `path` on its XLA padded route
    of the same family; (per-step or summed counts, last dt, live rows)."""
    cfg = J.SimulationConfig.from_json(path)
    family = cfg.solver.kind.split("_")[0]
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, kind=f"{family}_padded", use_pallas_slotmajor=False))
    key = (json.dumps(cfg.to_dict(), sort_keys=True), steps, per_step)
    if key not in _JAX_RUNS:
        _, solver, boundary, carry = cfg.build()
        simulate = jax.jit(solver.simulate, static_argnums=2)
        if per_step:
            runs = []
            for _ in range(steps):
                carry, diag = simulate(carry, boundary, 1)
                runs.append(counts(diag))
        else:
            carry, diag = simulate(carry, boundary, steps)
            runs = counts(diag)
        _JAX_RUNS[key] = (runs, np.float32(diag.dt), live_rows(solver, carry))
    return _JAX_RUNS[key]


def port_run(path, steps, per_step):
    _, solver, boundary, carry = T.SimulationConfig.from_json(path).build(device="cpu")
    if per_step:
        runs = []
        for _ in range(steps):
            carry, diag = solver.simulate(carry, boundary, 1)
            runs.append(counts(diag))
    else:
        carry, diag = solver.simulate(carry, boundary, steps)
        runs = counts(diag)
    return solver, (runs, np.float32(diag.dt), live_rows(solver, carry))


def assert_runs_agree(port, ref):
    (pc, pdt, prows), (jc, jdt, jrows) = port, ref
    assert pc == jc
    np.testing.assert_allclose(pdt, jdt, rtol=1e-6)
    assert prows.shape == jrows.shape
    np.testing.assert_allclose(prows[:, :2], jrows[:, :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(prows[:, 2], jrows[:, 2], rtol=1e-4, atol=1e-2)
    assert np.isfinite(prows).all()


# ------------------------------------------------------------------- schema


def test_json_written_by_either_package_loads_in_the_other(tmp_path):
    """A default and a non-default config (every section changed) round-trip
    through both packages' to_json / from_json, dict-equal."""
    configs = [J.SimulationConfig(), dataclasses.replace(
        small_config(J, "wcsph_plane", "physical", pair_dtype="bfloat16",
                     rebuild_every=2, pallas_pf_chunk_lanes=128,
                     dense_boundary_occupancy=10, dense_ny_multiple=4),
        gravity=(0.5, -3.0),
        timestep=J.TimestepConfig(cfl_factor=0.3, target_frame_length=1 / 60))]
    for k, jcfg in enumerate(configs):
        path = str(tmp_path / f"jax{k}.json")
        jcfg.to_json(path)
        tcfg = T.SimulationConfig.from_json(path)
        assert tcfg.to_dict() == jcfg.to_dict()
        back = str(tmp_path / f"port{k}.json")
        tcfg.to_json(back)
        assert J.SimulationConfig.from_json(back) == jcfg
        with open(path) as a, open(back) as b:
            assert json.load(a) == json.load(b)
    assert T.SimulationConfig().to_dict() == J.SimulationConfig().to_dict()
    assert [dataclasses.asdict(op) for op in T.default_scene()] == [
        dataclasses.asdict(op) for op in J.default_scene()]


def test_unknown_keys_rejected():
    for d in ({"fluid": {"particle_densty": 100.0}}, {"solver": {"pallas_tile": 4}},
              {"scene": [{"op": "fluid_rect", "rect": [0, 0, 1, 1], "spin": 1}]}):
        with pytest.raises(ValueError, match="unknown"):
            T.SimulationConfig.from_dict(d)


def test_every_solver_field_is_wired_or_a_tpu_layout_knob():
    fields = [f.name for f in dataclasses.fields(T.SolverConfig)]
    assert fields == [f.name for f in dataclasses.fields(J.SolverConfig)]
    for name in fields:
        assert (name in T.WIRED_SOLVER_FIELDS) + (name in T.TPU_LAYOUT_KNOBS) == 1, name
    assert T.WIRED_SOLVER_FIELDS | T.TPU_LAYOUT_KNOBS == set(fields)
    assert T.TPU_LAYOUT_KNOBS == {
        "pallas_pf_chunk_lanes", "pallas_pf_stat_chunk_lanes",
        "pallas_pf_rebucket_chunk_lanes", "pallas_pf_unroll", "pallas_sm_row_block"}


def test_build_wires_every_field():
    """Non-default values of every wired field reach the solver, its grid,
    its boundary and its carry; the TPU layout knobs load and change
    nothing."""
    tpu = dict(pallas_pf_chunk_lanes=128, pallas_pf_stat_chunk_lanes=256,
               pallas_pf_rebucket_chunk_lanes=384, pallas_pf_unroll=True,
               pallas_sm_row_block=4)
    cfg = dataclasses.replace(
        small_config(T, "dfsph_plane", "physical", max_avg_density_error=2e-4,
                     max_density_iterations=77, max_divergence_error=3e-3,
                     max_divergence_iterations=55, dense_occupancy=9,
                     dense_boundary_occupancy=12, dense_ny_multiple=8, rebuild_every=3,
                     pair_dtype="bfloat16", **tpu),
        gravity=(0.25, -7.0),
        timestep=T.TimestepConfig(timestep_max=1 / 200, timestep_min=1 / 9000,
                                  target_frame_length=1 / 30))
    world, solver, boundary, carry = cfg.build(device="cpu")
    assert isinstance(solver, t_plane.DFSPHPlaneSolver)
    assert (solver.max_avg_density_error, solver.max_density_iterations,
            solver.max_divergence_error, solver.max_divergence_iterations,
            solver.rebuild_every) == (2e-4, 77, 3e-3, 55, 3)
    assert solver.gravity == (0.25, -7.0)
    assert type(solver.viscosity_model).__name__ == "PhysicalViscosityModel"
    assert solver.viscosity_model.fluid_viscosity == 0.01
    sc = solver.step_config
    assert (sc.timestep_max, sc.timestep_min, sc.cfl_factor,
            sc.target_frame_length) == (1 / 200, 1 / 9000, 1.5, 1 / 30)
    g = solver.grid
    assert (g.occupancy, g.ny % 8, g.pair_dtype, g.use_pallas_slotmajor) == (
        9, 0, "bfloat16", True)
    assert boundary.dense.mask.shape[-1] == 12
    assert carry.ctx.geom.pos.dtype == torch.bfloat16
    # the TPU knobs: the same solver without them
    plain = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **{k: getattr(T.SolverConfig(), k) for k in tpu}))
    assert plain.build(device="cpu")[1] == solver

    w = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, kind="wcsph_padded", pair_dtype="float32",
        boundary_force_factor=0.5, target_density_variation=0.02,
        expected_max_flow_speed=2.0, use_pallas_slotmajor=True))
    _, ws, _, _ = w.build(device="cpu")
    assert (ws.boundary_force_factor, ws.target_density_variation,
            ws.expected_max_flow_speed, ws.step_config.cfl_factor,
            ws.grid.use_pallas_slotmajor) == (0.5, 0.02, 2.0, 0.2, True)


def test_unported_kinds_and_refusals():
    for kind in T.UNPORTED_KINDS:
        with pytest.raises(ValueError, match="does not have"):
            small_config(T, kind).build(device="cpu")
    with pytest.raises(ValueError, match="unknown solver kind"):
        small_config(T, "sph").build(device="cpu")
    with pytest.raises(ValueError, match="unknown viscosity kind"):
        dataclasses.replace(small_config(T, "dfsph_padded"),
                            viscosity=T.ViscosityConfig(kind="xsp")).build(device="cpu")
    # bf16 on the padded kinds: K5's bf16 math mode builds and runs; K3
    # (use_pallas_slotmajor) still refuses it, as the JAX padded solvers assert
    for kind in ("dfsph_padded", "wcsph_padded"):
        cfg = small_config(T, kind, pair_dtype="bfloat16")
        world, solver, boundary, carry = cfg.build(device="cpu")
        carry, diag = solver.simulate(carry, boundary, 1)
        assert solver.grid.pair_dtype == "bfloat16" and diag.neighbor_drops == 0
        state = solver.export_state(carry)
        assert bool(torch.isfinite(state.positions[state.alive]).all())
        with pytest.raises(ValueError, match="bfloat16"):
            small_config(T, kind, pair_dtype="bfloat16",
                         use_pallas_slotmajor=True).build(device="cpu")
    if not torch.cuda.is_available():  # no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            small_config(T, "dfsph_padded").build()


# ------------------------------------------------------- kinds against JAX


@pytest.mark.parametrize("visc", ["xsph", "physical"])
@pytest.mark.parametrize("port_kind", list(PORT_KINDS))
def test_kind_steps_as_jax(tmp_path, port_kind, visc):
    kind, slot = PORT_KINDS[port_kind]
    path = str(tmp_path / "cfg.json")
    small_config(J, kind, visc, use_pallas_slotmajor=slot).to_json(path)
    solver, port = port_run(path, STEPS, per_step=True)
    assert solver.grid.use_pallas_slotmajor == (slot or kind.endswith("plane"))
    assert_runs_agree(port, jax_reference(path, STEPS, per_step=True))


@pytest.mark.parametrize("port_kind", ["dfsph_padded_k5", "dfsph_padded_k3", "dfsph_plane"])
def test_rebuild_every_as_jax(tmp_path, monkeypatch, port_kind):
    """rebuild_every = 3 over 7 steps: two blocks of one rebuilding step and
    two stale ones, then one leftover rebuild (3 re-bucket calls), against the
    JAX padded solver's own blocking (summed counts, the same tolerances)."""
    kind, slot = PORT_KINDS[port_kind]
    path = str(tmp_path / "cfg.json")
    small_config(J, kind, "physical", use_pallas_slotmajor=slot,
                 rebuild_every=3).to_json(path)
    module, name = (t_plane, "rebucket_planes") if kind == "dfsph_plane" \
        else (t_dense, "sm_rebucket_parts")
    calls = []
    rebuild = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or rebuild(*a, **k))
    solver, port = port_run(path, 7, per_step=False)
    assert solver.rebuild_every == 3
    assert len(calls) == 3
    assert_runs_agree(port, jax_reference(path, 7, per_step=False))


# --------------------------------------------------------------------- CLI


def test_cli_run_prints_the_jax_keys_and_dump_config_loads_in_jax(tmp_path):
    cfg_path = tmp_path / "cfg.json"
    small_config(T, "wcsph_padded", "physical").to_json(str(cfg_path))
    # one thread, as the test process: the suite's workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "yasph2d_tpu_torch", "run", "--config", str(cfg_path),
         "--steps", "3", "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    record = json.loads(run.stdout.strip().splitlines()[-1])
    assert list(record) == ["steps", "wall_s", "simulated_s", "dt", "finite",
                            "neighbor_drops", "density_iterations",
                            "divergence_iterations"]
    assert record["steps"] == 3 and record["finite"] and record["neighbor_drops"] == 0
    assert record["density_iterations"] == record["divergence_iterations"] == 0  # WCSPH

    out = tmp_path / "default.json"
    dump = subprocess.run([sys.executable, "-m", "yasph2d_tpu_torch", "dump-config", str(out)],
                          cwd=str(tmp_path), env=env, capture_output=True, text=True,
                          timeout=300)
    assert dump.returncode == 0, dump.stderr
    assert J.SimulationConfig.from_json(str(out)) == J.SimulationConfig()


def test_main_takes_an_argument_list(tmp_path, capsys):
    from yasph2d_tpu_torch.__main__ import main

    cfg_path = str(tmp_path / "cfg.json")
    small_config(T, "dfsph_plane", "physical").to_json(cfg_path)
    run = main(["run", "--config", cfg_path, "--steps", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == run.record
    assert run.record["steps"] == 2 and run.record["finite"]
    assert run.record["density_iterations"] >= 2
    assert int(run.carry.time.num_steps) == 2 and run.world.num_dynamic_particles > 100
    assert run.solver._forms.visc_gravity.name == "visc_gravity_phys"
    assert bool(run.boundary.geom.mask.any())  # the plane-form boundary it stepped against


@pytest.mark.parametrize("target", [2_000, 10_000])
def test_reference_dam_break_is_the_jax_config_scene(target):
    """scenes.reference_dam_break (bench.py:310-324) is the JAX default scene
    at the bench's particle density: the same particles, exactly."""
    from yasph2d_tpu_torch.scenes import reference_dam_break

    port = reference_dam_break(target)
    ref = J.SimulationConfig(
        fluid=J.FluidConfig(particle_density=target / (0.5 * 0.81))).build_world()
    assert port.num_dynamic_particles == ref.num_dynamic_particles
    assert abs(port.num_dynamic_particles - target) < 0.1 * target
    np.testing.assert_array_equal(port.host_positions(), np.asarray(ref.host_positions()))
    np.testing.assert_array_equal(port.host_boundary_positions(),
                                  np.asarray(ref.host_boundary_positions()))


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package; importing the whole port loads no jax."""
    sources = sorted((ROOT / "yasph2d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 20
    for src in sources:
        for node in ast.walk(ast.parse(src.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level \
                else []
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "yasph2d_tpu"), (src, name)
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in (ROOT / "yasph2d_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "assert not any(k.split('.')[0] in ('jax', 'yasph2d_tpu') for k in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
