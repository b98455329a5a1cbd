"""Where the harness finds each piece by name.

- `BENCHMARK.json` at the checkout's root: the cells (`workloads`), their
  configuration and traffic names, the metrics;
- a configuration: the `file` that `BENCHMARK.json` gives it
  (`configs/<config>.json`): method, adapter, solver knobs, viscosity,
  time step;
- a traffic mix: `traffic/<traffic>.json`: the scene and its size;
- a cell's own settings: `workloads/<cell>.json`: slots a cell, settle and
  segment steps, the compared steps and the limits of the comparison;
- a scene: `scenes/<scene>.json`, read by `scene_gen.py`;
- an end-to-end metric: the reader `e2e/<metric>.py`; a per-layer metric:
  the reader `metrics/<metric>.py`. A reader is a module with
  `read(readings) -> float | None`;
- a solver: `adapters/<adapter>.py`;
- `parked.json`: configurations, cells and metrics in BENCHMARK.json's form
  that the benchmark holds out (its `why` says why); `with_parked` adds them
  for the CPU tests.
"""

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    config: dict
    traffic: dict
    settings: dict  # workloads/<cell>.json
    scene: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> dict:
    return _json(root / "BENCHMARK.json")


def with_parked(bench: dict) -> dict:
    """`bench` with the entries of parked.json added."""
    parked = _json(HERE / "parked.json")
    return {key: (value + parked[key] if key in ("configs", "workloads", "per_layer")
                  else value) for key, value in bench.items()}


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root: Path, name: str, bench: dict = None) -> Cell:
    """Everything the harness reads for the cell `name`; raises KeyError for
    a cell that BENCHMARK.json does not list."""
    bench = bench or benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = _json(root / config_entry["file"])
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name, entry=entry, config=config, traffic=traffic,
        settings=_json(HERE / "workloads" / f"{name}.json"),
        scene=_json(HERE / "scenes" / f"{traffic['scene']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)])


def reader(kind: str, name: str):
    """The reader module of metric `name`: kind "e2e" or "metrics"."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adapter(name: str):
    return importlib.import_module(f"portbench.adapters.{name}")
