"""K3, the masked pair reduction over each query slot's 3x3 cell neighbourhood
in the padded slot-major layout (PyTorch port of
yasph2d_tpu/ops/pallas_slotmajor.py sm_pair_reduce).

`sm_pair_reduce` dispatches on the device of its tensors: a CUDA tensor
launches the hand-written kernel of csrc/sm_pair_reduce.cu (one instantiation
per call form, named by `PairForm.name`), a CPU tensor runs the plain PyTorch
twin `sm_pair_reduce_ref`. There is no fallback from one to the other.

Contract (the JAX kernel's): for every live query slot (y, x, p), sum
term_fn(dx, dy, r_sq, r, scalars, q_comps, s_comps) over the source slots of
the 3x3 cells around (y, x) in (dyv, dxv, sp) order, where dx = x_j - x_i and a
pair is valid when the query and the source are live and 1e-10 < r_sq <= h^2.
Dead query slots output zeros. There is no epilogue. Positions are
(ny, nx, P, 2), masks (ny, nx, P), values (ny, nx, P) or (ny, nx, P, C) (a
vector contributes its C components, in order); the source space may have
Ps != P slots. The output is (ny, nx, P, n_out), vector-last like the carry.
"""

import torch

from . import cuda_build
from .dense_grid import MIN_DISTANCE_SQ
from .pair_reduce import PairForm

# kernel launches per call form, counted where the wrapper launches
LAUNCHES = {form: 0 for form in cuda_build.SM_PAIR_FORMS}


def reset_launch_counts():
    for form in LAUNCHES:
        LAUNCHES[form] = 0


def _comps(vals) -> list:
    """Logical (ny, nx, P) components of slot-layout values."""
    out = []
    for v in vals:
        out.extend([v] if v.ndim == 3 else list(v.unbind(-1)))
    return out


def sm_pair_reduce_ref(term_fn, n_out: int, q_pos, q_mask, s_pos, s_mask,
                       radius_sq: float, q_vals=(), s_vals=(), scalars=()):
    """Plain PyTorch twin of K3: nine shifted views of the one-cell-padded
    source space; per view the terms of all Ps source slots are evaluated at
    once ((ny, nx, P, Ps) candidates) and added slot by slot, which keeps the
    kernel's (dyv, dxv, sp) order. Returns (ny, nx, P, n_out)."""
    ny, nx, _ = q_mask.shape
    ps = s_mask.shape[2]

    def pad(a):  # one dead cell ring around the grid (dims 0 and 1)
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    s_pos = pad(s_pos)
    s_mask = pad(s_mask)
    s_comps = [pad(c) for c in _comps(s_vals)]
    qx, qy = q_pos[..., 0, None], q_pos[..., 1, None]  # (ny, nx, P, 1)
    q_comps = tuple(c[..., None] for c in _comps(q_vals))
    q_live = q_mask[..., None]
    radius_sq = torch.tensor(radius_sq, dtype=q_pos.dtype, device=q_pos.device)
    accs = [torch.zeros_like(q_pos[..., 0]) for _ in range(n_out)]
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            dx = s_pos[rows, cols, None, :, 0] - qx
            dy = s_pos[rows, cols, None, :, 1] - qy
            r_sq = dx * dx + dy * dy
            valid = (
                q_live & s_mask[rows, cols, None, :]
                & (r_sq <= radius_sq) & (r_sq > MIN_DISTANCE_SQ)
            )
            s_planes = tuple(c[rows, cols, None, :] for c in s_comps)
            outs = term_fn(dx, dy, r_sq, torch.sqrt(r_sq), scalars, q_comps, s_planes)
            for sp in range(ps):
                # where, not a multiply: invalid candidates may hold inf/NaN
                accs = [a + torch.where(valid[..., sp], o[..., sp], 0.0)
                        for a, o in zip(accs, outs)]
    return torch.stack(accs, dim=-1)


def _value_ptrs(vals, device, shape, what):
    """(pointer, element stride) of each logical component, no copy: a scalar
    is (base, 1), component k of a (.., C) vector is (base + k, C)."""
    ptrs, strides = [], []
    for v in vals:
        c = 1 if v.ndim == 3 else v.shape[-1]
        cuda_build.check_tensor(v, device, shape if v.ndim == 3 else shape + (c,),
                                torch.float32, what)
        ptrs.extend(v.data_ptr() + k * v.element_size() for k in range(c))
        strides.extend([c] * c)
    return ptrs, strides


def slot_operands(kernel: str, q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars):
    """Check the operands of a slot-major pair kernel (K3, K5) and return
    ((ny, nx, P, Ps), value pointers, value strides, the f32 scalar)."""
    device = q_pos.device
    ny, nx, p = q_mask.shape
    ps = s_mask.shape[2]
    for t, shape, dtype, what in (
            (q_pos, (ny, nx, p, 2), torch.float32, "query positions"),
            (q_mask, (ny, nx, p), torch.bool, "query mask"),
            (s_pos, (ny, nx, ps, 2), torch.float32, "source positions"),
            (s_mask, (ny, nx, ps), torch.bool, "source mask")):
        cuda_build.check_tensor(t, device, shape, dtype, f"{kernel}: {what}")
    if q_pos.data_ptr() % 8 or s_pos.data_ptr() % 8:
        raise ValueError(f"{kernel}: positions must be 8-byte aligned (float2)")
    if len(scalars) > 1:
        raise ValueError(f"{kernel}: the CUDA forms take at most one scalar")
    q_ptrs, q_strides = _value_ptrs(q_vals, device, (ny, nx, p), f"{kernel}: query value")
    s_ptrs, s_strides = _value_ptrs(s_vals, device, (ny, nx, ps),
                                    f"{kernel}: source value")
    return ((ny, nx, p, ps), q_ptrs + s_ptrs, q_strides + s_strides,
            float(scalars[0]) if scalars else 0.0)


def sm_pair_reduce(form: PairForm, q_pos, q_mask, s_pos, s_mask,
                   consts: cuda_build.PairConsts, q_vals=(), s_vals=(),
                   scalars=()) -> torch.Tensor:
    """Run one K3 call form; returns (ny, nx, P, n_out). `consts.radius_sq` is
    the pair cutoff for both routes."""
    if form.post_fn is not None:
        raise ValueError("sm_pair_reduce: K3 forms have no epilogue")
    device = q_pos.device
    if device.type == "cpu":
        return sm_pair_reduce_ref(form.term_fn, form.n_out, q_pos, q_mask, s_pos,
                                  s_mask, consts.radius_sq, q_vals=q_vals,
                                  s_vals=s_vals, scalars=scalars)
    if device.type != "cuda":
        raise ValueError(f"sm_pair_reduce: unsupported device {device}")
    (ny, nx, p, ps), ptrs, strides, scalar = slot_operands(
        "sm_pair_reduce", q_pos, q_mask, s_pos, s_mask, q_vals, s_vals, scalars)
    out = torch.empty((ny, nx, p, form.n_out), dtype=torch.float32, device=device)
    fn = getattr(cuda_build.library(), f"sm_pair_reduce_{form.name}")
    err = fn(
        q_pos.data_ptr(), q_mask.data_ptr(), s_pos.data_ptr(), s_mask.data_ptr(),
        cuda_build.pointer_array(ptrs), cuda_build.int_array(strides), len(ptrs),
        out.data_ptr(), p, ps, ny, nx, scalar, consts,
        torch.cuda.current_stream(device).cuda_stream,
    )
    cuda_build.check(err, f"sm_pair_reduce_{form.name}")
    LAUNCHES[form.name] += 1
    return out
