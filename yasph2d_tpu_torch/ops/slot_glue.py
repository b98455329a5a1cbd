"""The padded WCSPH step's glue between its kernels, fused into four launches
(csrc/slot_glue.cu), with their plain PyTorch twins.

`WCSPHPaddedSolver.step` (models/wcsph_dense.py) runs, between its sync
points:

    slot_kick_drift    leapfrog part 1: v' = v + (0.5 dt) a, pos' = pos + v' dt
    slot_density_tait  density from the two density passes, clamped to rho0,
                       and its Tait pressure (`tait_pressure`)
    slot_accel_cfl     accel = where(mask, (accel_dyn + stat12) + g, 0) and the
                       live slots' largest |v + accel dt|^2, a 0-d tensor
    slot_kick          leapfrog part 2: v + (0.5 dt_new) accel

Each dispatches on the device of its tensors, as K1-K5 do: a CUDA tensor
launches the kernel (counted in LAUNCHES), a CPU tensor runs the twin
(`*_ref`), the step's torch operations as they were. Every output a later
reader observes is the twin's bits: the kernel runs the twin's float32
operations in its order (the library is built with -fmad=false). What a
kernel skips:
- slot_kick_drift leaves dead slots unwritten: its outputs feed K4 alone,
  which reads a dead slot of neither (ops/sm_rebucket.py); its twin writes
  them;
- slot_density_tait with `dead_zero` (the K5 route: K5 writes +0.0 at dead
  query slots) does not load a dead slot's pass outputs and writes the
  density and pressure of those zeros; without it (K3) it loads every slot;
- slot_accel_cfl loads no dead slot (they take 0);
- slot_kick loads no dead slot: its v is K4's output and its accel
  slot_accel_cfl's, both +0.0 there.
No kernel writes an input: the step's carry is never written in place.

Operands: contiguous float32 slot-major tensors of the mask's (ny, nx, P)
slots, (ny, nx, P, 2) vectors, the boundary pass's (ny, nx, P, 3) output
read in place. A wrapper raises on any other device, dtype or shape, and on
CUDA on a non-contiguous operand (its kernel reads raw slot-major memory).
"""

import torch

from ..units import REAL
from . import cuda_build
from .dense_grid import f32_scalar

# kernel launches, counted where the wrapper launches
LAUNCHES = {"slot_kick_drift": 0, "slot_density_tait": 0, "slot_accel_cfl": 0, "slot_kick": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tait_pressure(stiffness, fluid_density, local_density: torch.Tensor):
    """Tait EOS with pressure clamp for particle deficiency
    (reference: wscsph.rs:52-57), in the JAX package's f32 operations: the
    ratio divides by a tensor (a Python divisor becomes a reciprocal multiply
    on CUDA) and ratio**7 is XLA's integer_pow expansion."""
    rho0 = torch.tensor(fluid_density, dtype=REAL, device=local_density.device)
    ratio = torch.clamp(local_density / rho0, min=1.0)
    r2 = ratio * ratio
    r3 = ratio * r2
    r4 = r2 * r2
    return float(stiffness) * (r3 * r4 - 1.0)


# ------------------------------------------------------------------- twins


def kick_drift_ref(pos, v, accel, mask, half_dt: float, dt: float):
    """Leapfrog part 1 (wscsph.rs:141-151) -> (pos', v'); every slot."""
    v = v + half_dt * accel
    return pos + v * dt, v


def density_tait_ref(dyn_w, stat, mask, mass: float, w0: float, rho0: float,
                     stiffness: float, dead_zero: bool = False):
    """m (W(0) + dyn + stat), clamped to rho0 (fluidparticleworld.rs:197-231),
    and its Tait pressure -> (dens, pres); every slot."""
    dens = torch.clamp(mass * ((w0 + dyn_w) + stat[..., 0]), min=rho0)
    return dens, tait_pressure(stiffness, rho0, dens)


def accel_cfl_ref(accel_dyn, stat, v, mask, gravity, dt: float):
    """Accelerations with the boundary penalty and gravity, dead slots frozen
    (0), and the CFL's largest squared speed of v + accel dt over the live
    slots (wscsph.rs:158-167), dead slots 0 -> (accel, 0-d max)."""
    gvec = torch.tensor(gravity, dtype=REAL, device=v.device)
    accel = torch.where(mask[..., None], (accel_dyn + stat[..., 1:3]) + gvec, 0.0)
    vstar = v + accel * dt
    return accel, torch.where(mask, (vstar * vstar).sum(dim=-1), 0.0).max()


def kick_ref(v, accel, mask, half_dt: float):
    """Leapfrog part 2 (wscsph.rs:169-178); every slot."""
    return v + half_dt * accel


# ---------------------------------------------------------------- wrappers


def _check(what: str, mask, *operands) -> bool:
    """Raise unless `mask` is a bool (ny, nx, P) tensor and each (tensor, C)
    of `operands` a float32 one of the mask's slots on its device, (ny, nx,
    P) for C = 1, else (ny, nx, P, C); on CUDA each must also be contiguous,
    and a vector of two 8-byte aligned (float2). Returns whether it is CUDA."""
    device = mask.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {device}")
    if mask.dtype != torch.bool or mask.ndim != 3:
        raise ValueError(f"{what}: the mask must be a bool (ny, nx, P) tensor, got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    cuda = device.type == "cuda"
    for t, dtype, c in ((mask, torch.bool, 1),) + tuple((t, REAL, c) for t, c in operands):
        shape = tuple(mask.shape) + ((c,) if c > 1 else ())
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape or (
                cuda and (not t.is_contiguous() or (c == 2 and t.data_ptr() % 8))):
            raise ValueError(
                f"{what}: expected a {'contiguous ' if cuda else ''}{dtype} tensor on "
                f"{device} of shape {shape}, got {t.device} {t.dtype} {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (strided)'}")
    return cuda


def _launch(name: str, *args):
    err = getattr(cuda_build.library(), name)(
        *args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1


def slot_kick_drift(pos, v, accel, mask, half_dt: float, dt: float):
    """Leapfrog part 1 -> (pos', v'). On CUDA the dead slots of both are left
    unwritten (module docstring): only K4 reads them."""
    if not _check("slot_kick_drift", mask, (pos, 2), (v, 2), (accel, 2)):
        return kick_drift_ref(pos, v, accel, mask, half_dt, dt)
    out_pos, out_v = torch.empty_like(pos), torch.empty_like(v)
    _launch("slot_kick_drift", mask.data_ptr(), pos.data_ptr(), v.data_ptr(), accel.data_ptr(),
            out_pos.data_ptr(), out_v.data_ptr(), mask.numel(), f32_scalar(half_dt),
            f32_scalar(dt))
    return out_pos, out_v


def slot_density_tait(dyn_w, stat, mask, mass: float, w0: float, rho0: float,
                      stiffness: float, dead_zero: bool = False):
    """(dens, pres) of the density pass's (ny, nx, P) sums and the boundary
    pass's (ny, nx, P, 3) output; `dead_zero`: both hold +0.0 at dead slots
    (K5's), so the kernel need not load them."""
    if not _check("slot_density_tait", mask, (dyn_w, 1), (stat, 3)):
        return density_tait_ref(dyn_w, stat, mask, mass, w0, rho0, stiffness, dead_zero)
    dens, pres = torch.empty_like(dyn_w), torch.empty_like(dyn_w)
    _launch("slot_density_tait", mask.data_ptr(), dyn_w.data_ptr(), stat.data_ptr(),
            dens.data_ptr(), pres.data_ptr(), mask.numel(), f32_scalar(mass), f32_scalar(w0),
            f32_scalar(rho0), f32_scalar(stiffness), int(dead_zero))
    return dens, pres


def slot_accel_cfl(accel_dyn, stat, v, mask, gravity, dt: float):
    """(accel, the live slots' largest |v + accel dt|^2 as a 0-d tensor) from
    the forces pass's (ny, nx, P, 2) sums and the boundary pass's output."""
    if not _check("slot_accel_cfl", mask, (accel_dyn, 2), (stat, 3), (v, 2)):
        return accel_cfl_ref(accel_dyn, stat, v, mask, gravity, dt)
    accel = torch.empty_like(accel_dyn)
    max_sq = torch.empty((), dtype=REAL, device=mask.device)
    _launch("slot_accel_cfl", mask.data_ptr(), accel_dyn.data_ptr(), stat.data_ptr(),
            v.data_ptr(), accel.data_ptr(), max_sq.data_ptr(), mask.numel(),
            f32_scalar(gravity[0]), f32_scalar(gravity[1]), f32_scalar(dt))
    return accel, max_sq


def slot_kick(v, accel, mask, half_dt: float):
    """Leapfrog part 2; `v` and `accel` hold +0.0 at dead slots (K4's and
    slot_accel_cfl's outputs)."""
    if not _check("slot_kick", mask, (v, 2), (accel, 2)):
        return kick_ref(v, accel, mask, half_dt)
    out = torch.empty_like(v)
    _launch("slot_kick", mask.data_ptr(), v.data_ptr(), accel.data_ptr(), out.data_ptr(),
            mask.numel(), f32_scalar(half_dt))
    return out
