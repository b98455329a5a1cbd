"""PyTorch port vs JAX package: smoothing kernels, viscosity coefficients, the
adaptive time step and diagnostics, on numpy-seeded inputs.

Both sides run the same float32 operation sequence, so agreement is to
rtol 1e-6 (one f32 ulp is ~6e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yasph2d_tpu.models import viscosity as jvisc
from yasph2d_tpu.ops import smoothing_kernels as jk
from yasph2d_tpu import timemanager as jtm
from yasph2d_tpu.utils.diagnostics import Diagnostics as JDiagnostics
from yasph2d_tpu_torch.models import viscosity as tvisc
from yasph2d_tpu_torch.ops import smoothing_kernels as tk
from yasph2d_tpu_torch import timemanager as ttm
from yasph2d_tpu_torch.utils.diagnostics import Diagnostics as TDiagnostics

torch.set_num_threads(1)

SMOOTHING_LENGTHS = [0.5, 1.0, 123.0]
KERNELS = ["Poly6", "Spiky", "CubicSpline", "WendlandQuinticC2"]
RTOL = 1e-6


def _samples(h, seed):
    """Distances across and beyond the support, plus r = 0 and r = h exactly."""
    rng = np.random.default_rng(seed)
    r = np.concatenate([
        rng.uniform(0.0, 1.3 * h, 512), [0.0, h, 0.5 * h, 1e-6 * h]
    ]).astype(np.float32)
    return r * r, r


def _both(fn_j, fn_t, *arrays):
    out_j = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    out_t = fn_t(*(torch.as_tensor(a) for a in arrays)).numpy()
    return out_j, out_t


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("h", SMOOTHING_LENGTHS)
def test_kernel_evaluate_and_gradient(name, h):
    kj, kt = getattr(jk, name)(h), getattr(tk, name)(h)
    r_sq, r = _samples(h, seed=int(h * 10))
    for method in ("evaluate", "gradient_coefficient"):
        out_j, out_t = _both(getattr(kj, method), getattr(kt, method), r_sq, r)
        np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=0.0, err_msg=method)


@pytest.mark.parametrize("h", SMOOTHING_LENGTHS)
def test_viscosity_kernel(h):
    kj, kt = jk.Viscosity(h), tk.Viscosity(h)
    r_sq, r = _samples(h, seed=7)
    for method in ("evaluate", "laplacian"):
        out_j, out_t = _both(getattr(kj, method), getattr(kt, method), r_sq, r)
        np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=0.0, err_msg=method)


@pytest.mark.parametrize("h", SMOOTHING_LENGTHS)
def test_kernel_vector_gradient(h):
    rng = np.random.default_rng(3)
    d = rng.uniform(-h, h, (256, 2)).astype(np.float32)
    r_sq = (d * d).sum(-1)
    r = np.sqrt(r_sq)
    kj, kt = jk.WendlandQuinticC2(h), tk.WendlandQuinticC2(h)
    out_j = np.asarray(kj.gradient(jnp.asarray(d), jnp.asarray(r_sq), jnp.asarray(r)))
    out_t = kt.gradient(torch.as_tensor(d), torch.as_tensor(r_sq),
                        torch.as_tensor(r)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("model", ["XSPHViscosityModel", "PhysicalViscosityModel"])
@pytest.mark.parametrize("h", SMOOTHING_LENGTHS)
def test_viscous_coefficient(model, h):
    rng = np.random.default_rng(11)
    r_sq, r = _samples(h, seed=5)
    rho = rng.uniform(90.0, 140.0, r.shape).astype(np.float32)
    dt, mass = np.float32(1.0 / 3000.0), 0.0125
    mj, mt = getattr(jvisc, model)(h), getattr(tvisc, model)(h)
    out_j = np.asarray(mj.viscous_coefficient(
        jnp.float32(dt), jnp.asarray(r_sq), jnp.asarray(r), mass, jnp.asarray(rho)))
    out_t = mt.viscous_coefficient(
        float(dt), torch.as_tensor(r_sq), torch.as_tensor(r), mass,
        torch.as_tensor(rho)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=RTOL, atol=0.0)


def _step_configs():
    return [
        ("fixed", jtm.FixedTimeStep(1.0 / 3000.0), ttm.FixedTimeStep(1.0 / 3000.0)),
        ("adaptive",
         jtm.AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5),
         ttm.AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5)),
        ("target",
         jtm.AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5, target_frame_length=1 / 60),
         ttm.AdaptiveTimeStep(1 / 360, 1 / 24000, 1.5, target_frame_length=1 / 60)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["fixed", "adaptive", "target"])
def test_update_simulation_step(case):
    """Random clocks and velocities, including the x2 clamp (dt tiny) and the
    TargetFrameLength lower-bound branch."""
    _, cj, ct = _step_configs()[case]
    rng = np.random.default_rng(100 + case)
    particle_diameter = 0.0102
    sj, st = jtm.TimeState.initial(cj), ttm.TimeState.initial(ct)
    assert float(sj.dt) == float(st.dt)
    assert float(sj.target_frame_length) == float(st.target_frame_length)
    for _ in range(64):
        dt = np.float32(10.0 ** rng.uniform(-6, -2))
        total = np.float32(rng.uniform(0.0, 3.0))
        vmax = np.float32(10.0 ** rng.uniform(-3, 2))
        sj = sj._replace(dt=jnp.float32(dt), total_simulated_time=jnp.float32(total))
        st = st._replace(dt=dt, total_simulated_time=total)
        sj, st = sj.account_step(), st.account_step()
        assert float(sj.total_simulated_time) == float(st.total_simulated_time)
        assert int(sj.num_steps) == int(st.num_steps)
        nj = jtm.update_simulation_step(cj, sj, particle_diameter, jnp.float32(vmax))
        nt = ttm.update_simulation_step(ct, st, particle_diameter, vmax)
        np.testing.assert_allclose(float(nt.dt), float(nj.dt), rtol=RTOL, atol=0.0)
        assert isinstance(nt.dt, np.float32)


def test_diagnostics_accumulate():
    rng = np.random.default_rng(9)
    aj, at = JDiagnostics.zeros(), TDiagnostics.zeros()
    for _ in range(5):
        f = [np.float32(x) for x in rng.uniform(0, 1, 4)]
        i = [int(x) for x in rng.integers(0, 50, 4)]
        dj = JDiagnostics(jnp.float32(f[0]), jnp.float32(f[1]), jnp.int32(i[0]),
                          jnp.int32(i[1]), jnp.int32(i[2]), jnp.float32(f[2]),
                          jnp.float32(f[3]), jnp.int32(i[3]))
        dt_ = TDiagnostics(f[0], f[1], i[0], i[1], i[2], f[2], f[3], i[3])
        aj, at = aj.accumulate(dj), at.accumulate(dt_)
    for field in TDiagnostics._fields:
        assert float(getattr(at, field)) == float(getattr(aj, field)), field
