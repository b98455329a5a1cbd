"""ops/slot_glue.py on the CPU: its twins are the padded WCSPH step's glue as
the step wrote it in torch operations, bit for bit, on the K3, K5 and K5
bf16 routes; its wrappers refuse an operand their kernels do not take; and
a step on CPU tensors launches nothing. The kernels against the twins on
the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from yasph2d_tpu_torch.models.wcsph_dense import WCSPHPaddedCarry
from yasph2d_tpu_torch.ops import slot_glue as sg
from yasph2d_tpu_torch.ops.sm_rebucket import sm_rebucket_parts
from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
from yasph2d_tpu_torch.timemanager import update_simulation_step

f32 = np.float32
CPU = torch.device("cpu")


def _inline_step(solver, carry, boundary):
    """The padded WCSPH step with its glue inline in torch operations, as it
    was written before ops/slot_glue.py (one device)."""
    dt, time_state = carry.time.dt, carry.time
    v = carry.v_pad + float(f32(0.5) * dt) * carry.accel_pad
    pos = carry.pos_pad + v * float(dt)
    pos, mask, (v,), drops = sm_rebucket_parts(pos, carry.mask, (v,), solver.grid)
    f, pair = solver._forms, solver._slot_pair
    dyn_w = pair(f.density, pos, mask, pos, mask, None)[..., 0]
    stat = pair(f.stat, pos, mask, boundary.pos_pad, boundary.mask, boundary.halo)
    m = float(solver.properties.particle_mass)
    dens = torch.clamp(m * ((solver._w0 + dyn_w) + stat[..., 0]),
                       min=solver.properties.fluid_density)
    rho0 = torch.tensor(solver.properties.fluid_density, dtype=torch.float32)
    ratio = torch.clamp(dens / rho0, min=1.0)
    r2 = ratio * ratio
    r3 = ratio * r2
    r4 = r2 * r2
    pres = float(solver.stiffness) * (r3 * r4 - 1.0)
    accel = pair(f.forces, pos, mask, pos, mask, None, q_vals=(pres, dens, v),
                 s_vals=(pres, dens, v), scalars=(float(dt),)) + stat[..., 1:3]
    gvec = torch.tensor(solver.gravity, dtype=torch.float32)
    accel = torch.where(mask[..., None], accel + gvec, 0.0)
    vstar = v + accel * float(dt)
    max_velocity = f32(torch.sqrt(torch.where(mask, (vstar * vstar).sum(dim=-1), 0.0).max()))
    time_state = update_simulation_step(solver.step_config, time_state,
                                        solver.properties.particle_radius * 2.0, max_velocity)
    v = v + float(f32(0.5) * time_state.dt) * accel
    carry = WCSPHPaddedCarry(pos_pad=pos, v_pad=v, accel_pad=accel, dens_pad=dens, mask=mask,
                             time=time_state)
    return carry, max_velocity, int(drops + boundary.num_dropped)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("kind", ["wcsph_padded", "wcsph_padded_k5", "wcsph_padded_k5_bf16"])
def test_step_equals_its_inline_glue_bit_for_bit(kind):
    """Six steps after 20 from rest (the columns falling, the first slots
    moving between cells): the step through the twins gives the inline
    glue's carry, CFL velocity and drops, every slot's bits, dead ones
    too."""
    world = double_dam_break(3000)
    solver, boundary = bench_solver(kind, world, device=CPU)
    carry = solver.init_carry(world.initial_state(device=CPU), boundary)
    carry, _ = solver.simulate(carry, boundary, 20)
    ref = carry
    for _ in range(6):
        carry, diag = solver.step(carry, boundary)
        ref, max_velocity, drops = _inline_step(solver, ref, boundary)
        for name in ("pos_pad", "v_pad", "accel_pad", "dens_pad", "mask"):
            a, b = getattr(carry, name), getattr(ref, name)
            assert torch.equal(_bits(a.contiguous()), _bits(b.contiguous())), name
        assert carry.time == ref.time
        assert f32(diag.max_velocity).tobytes() == max_velocity.tobytes()
        assert diag.neighbor_drops == drops
    assert float(carry.v_pad.abs().max()) > 0 and bool((carry.accel_pad != 0).any())


def test_cpu_steps_launch_nothing():
    world = double_dam_break(3000)
    solver, boundary = bench_solver("wcsph_padded_k5", world, device=CPU)
    carry = solver.init_carry(world.initial_state(device=CPU), boundary)
    before = dict(sg.LAUNCHES)
    solver.simulate(carry, boundary, 3)
    assert sg.LAUNCHES == before


def _operands(ny=3, nx=4, p=2):
    g = torch.Generator().manual_seed(0)

    def vec(c):
        return torch.rand((ny, nx, p, c), generator=g)

    mask = torch.rand((ny, nx, p), generator=g) < 0.5
    return dict(
        slot_kick_drift=lambda m, s, v: sg.slot_kick_drift(v, v, v, m, 0.5, 1.0),
        slot_density_tait=lambda m, s, v: sg.slot_density_tait(s, vec(3), m, 1.0, 0.5, 100.0,
                                                               10.0),
        slot_accel_cfl=lambda m, s, v: sg.slot_accel_cfl(v, vec(3), v, m, (0.0, -9.81), 1.0),
        slot_kick=lambda m, s, v: sg.slot_kick(v, v, m, 0.5),
    ), mask, torch.rand((ny, nx, p), generator=g), vec(2)


@pytest.mark.parametrize("fault", ["float64", "planes", "slots", "mask_dtype"])
@pytest.mark.parametrize("name", list(sg.LAUNCHES))
def test_wrappers_refuse_other_operands(name, fault):
    """Each wrapper runs on the slot-major operands and refuses a float64
    operand, the plane layout (C, P, ny, nx), another slot count, and a
    mask that is not bool."""
    calls, mask, scalar, vec = _operands()
    calls[name](mask, scalar, vec)
    if fault == "float64":
        scalar, vec = scalar.double(), vec.double()
    elif fault == "planes":
        scalar, vec = scalar.permute(2, 0, 1), vec.permute(3, 2, 0, 1)
    elif fault == "slots":
        scalar, vec = scalar[..., :1], vec[..., :1, :]
    else:
        mask = mask.to(torch.uint8)
    with pytest.raises(ValueError, match=name):
        calls[name](mask, scalar, vec)


def test_twins_cfl_max_of_no_live_slot_and_of_a_nan():
    """The CFL max is 0 with no live slot and NaN where a live speed is."""
    mask = torch.zeros((2, 3, 4), dtype=torch.bool)
    v = torch.full((2, 3, 4, 2), 5.0)
    stat = torch.zeros((2, 3, 4, 3))
    accel, max_sq = sg.accel_cfl_ref(v, stat, v, mask, (0.0, -9.81), 0.01)
    assert float(max_sq) == 0.0 and not bool(accel.any())
    mask[1, 2, 0] = True
    v[1, 2, 0, 1] = float("nan")
    assert torch.isnan(sg.accel_cfl_ref(v, stat, v, mask, (0.0, -9.81), 0.01)[1])
