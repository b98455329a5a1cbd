"""`python -m yasph2d_tpu_torch record` against the JAX package's `record`, on
the CPU.

The same small SimulationConfig JSON (kind `dfsph_padded`, the reference
scene at 2500 particles/m^2, the calm scene of tests/test_torch_app.py: at
1600 the first step ejects a particle and the two packages' runs part within
the first frame, see there) goes to the port's `__main__.main(["record",
"--device", "cpu", ...])` and to JAX's `cmd_record` (an argparse Namespace
with `backend="cpu"`), 2 frames at 160x90. Both must write the same file
names, with the same steps in each frame, and the decoded frames may differ
on under 0.1% of pixels. `main` returns the app. A `record --device cuda`
without a card raises.
"""

import argparse

import numpy as np
import pytest
import torch
from PIL import Image

import yasph2d_tpu.__main__ as j_main
import yasph2d_tpu.app as J
import yasph2d_tpu_torch.app as T
from yasph2d_tpu_torch import config as C
from yasph2d_tpu_torch.__main__ import main

FRAMES = 2
DENSITY = 2500.0


@pytest.fixture(scope="module")
def config_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "record.json"
    C.SimulationConfig(fluid=C.FluidConfig(particle_density=DENSITY),
                       solver=C.SolverConfig(kind="dfsph_padded")).to_json(str(path))
    return str(path)


def steps_per_frame(monkeypatch, mod):
    """Wrap `mod`'s SimulationApp.draw() to keep the steps each frame's
    update() ran."""
    steps = []
    draw = mod.SimulationApp.draw

    def counting_draw(self):
        steps.append(self.time_manager.num_simulation_steps_this_frame)
        return draw(self)

    monkeypatch.setattr(mod.SimulationApp, "draw", counting_draw)
    return steps


def test_record_matches_jax(tmp_path, config_path, monkeypatch, capsys):
    out_t, out_j = tmp_path / "port", tmp_path / "jax"
    port_steps = steps_per_frame(monkeypatch, T)
    app = main(["record", "--device", "cpu", "--frames", str(FRAMES), "--resolution",
                "160x90", "--config", config_path, "--out", str(out_t)])
    assert f"wrote {FRAMES} frames" in capsys.readouterr().out
    steps = steps_per_frame(monkeypatch, J)
    j_main.cmd_record(argparse.Namespace(config=config_path, frames=FRAMES, out=str(out_j),
                                         resolution="160x90", backend="cpu"))
    names = sorted(p.name for p in out_t.iterdir())
    assert names == sorted(p.name for p in out_j.iterdir())
    assert names == sorted(f"{i}.png" for i in range(FRAMES))
    assert port_steps == steps and len(steps) == FRAMES
    assert app.solver_name == "dfsph_padded" and app.device.type == "cpu"
    assert list(app.warnings) == []
    for name in names:
        a = np.asarray(Image.open(out_t / name))
        b = np.asarray(Image.open(out_j / name))
        assert a.shape == b.shape == (90, 160, 3)
        mismatch = (a != b).any(axis=-1).mean()
        assert mismatch < 0.001, f"{name}: {mismatch:.4%} of pixels differ"


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_record_on_cuda_without_a_card_raises(tmp_path, config_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["record", "--frames", "1", "--config", config_path, "--out", str(tmp_path)])
