"""The slot-major ctx-pass probe (PyTorch port of tools/probe_pallas_slotmajor.py).

    python -m yasph2d_tpu_torch.tools.probe_pallas_slotmajor check  # K7 vs K1 ctx
    python -m yasph2d_tpu_torch.tools.probe_pallas_slotmajor gpu    # time both

The probe computes the ctx pass (W, m grad W, |m grad W|^2 and the neighbour
count for every query slot, over its 3x3 cells x Ps source slots) as one kernel,
K7: K1's kernel (csrc/pair_reduce.cu, its launch shape from
ops/pair_reduce.py `tile_shape`) with the probe's own Wendland statement
(csrc/pair_terms.cuh ProbeCtxTerm), no epilogue, and the probe's planes read
in place, the masks as plane 2 > 0; any P and Ps whose cell tile fits a block.
Its layout is the port's: query and source planes (3, P, ny, nx) = x, y and
the mask as 0/1, output (5, P, ny, nx); the TPU probe's row bands, haloed
windows and 128-lane padding are not ported.

`check` holds K7 against the pair kernel K1's `ctx` form, which computes the
same five sums with the solver's Wendland statement, on the TPU probe's check
inputs (12 x 40 cells, P 5, h 0.1, m 0.07, a 60% mask, seed 0). `gpu` times
K7 and K1 `ctx` on the same inputs at the TPU probe's 1M band shape (64 x 1612
cells, P 7, h 0.004, m 0.001); K1 `ctx` takes the place of the TPU probe's
XLA pair_reduce yardstick; both now run one kernel design, so their ratio
measures the probe's statement against K1's ctx term. Both run on the card
unless `--device cpu` is given; a CPU tensor runs the plain twin
`ctx_pass_ref`.
"""

import argparse

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.dense_grid import MIN_DISTANCE_SQ, f32_scalar
from ..ops.pair_reduce import PairForm, pair_reduce, tile_shape
from ..ops.planes import PlaneGeom
from ..ops.smoothing_kernels import WendlandQuinticC2

CHECK_SHAPE = dict(ny=12, nx=40, p=5, h=0.1, m=0.07)
GPU_SHAPE = dict(ny=64, nx=1612, p=7, h=0.004, m=0.001)

# K7 launches, counted where the wrapper launches
LAUNCHES = {"probe_ctx": 0}


def reset_launch_counts():
    LAUNCHES["probe_ctx"] = 0


def probe_consts(h: float, m: float) -> cuda_build.PairConsts:
    """The probe's Python-float constants (:48-53), each rounded to f32 once
    where it meets an f32 plane, in the pair kernels' constants: h^2, 1/h,
    28/(pi h^2), 140/(pi h^4) and m (csrc/pair_terms.cuh ProbeCtxTerm)."""
    return cuda_build.PairConsts(
        radius_sq=h * h, w_h_inv=1.0 / h, w_norm=28.0 / (np.pi * h * h),
        w_norm_grad=140.0 / (np.pi * h ** 4), mass=m)


def probe_inputs(ny: int, nx: int, p: int, h: float, seed: int = 0):
    """The TPU probe's inputs (run_check / run_tpu): positions uniform in
    their own cell, a 60% random mask, from numpy's generator. Returns
    (pos (ny, nx, P, 2) f32, mask (ny, nx, P) bool) as numpy arrays."""
    rng = np.random.default_rng(seed)
    iy, ix = np.indices((ny, nx))
    pos = ((rng.uniform(0, 1, (ny, nx, p, 2)) + np.stack([ix, iy], -1)[:, :, None, :])
           * h).astype(np.float32)
    mask = rng.uniform(size=(ny, nx, p)) < 0.6
    return pos, mask


def probe_planes(pos, mask, device="cuda") -> torch.Tensor:
    """(ny, nx, P, 2) positions + (ny, nx, P) mask -> (3, P, ny, nx) f32
    planes x, y, mask as 0/1: the probe's operand layout."""
    pos = torch.as_tensor(np.asarray(pos), dtype=torch.float32)
    mask = torch.as_tensor(np.asarray(mask)).to(torch.float32)
    planes = torch.stack([pos[..., 0], pos[..., 1], mask])  # (3, ny, nx, P)
    return planes.permute(0, 3, 1, 2).contiguous().to(device)


def ctx_pass_ref(q: torch.Tensor, s: torch.Tensor, h: float, m: float) -> torch.Tensor:
    """Plain twin of K7: the probe's statement on nine shifted views of the
    one-cell-padded source planes, each view's Ps slots added in order."""
    _, p, ny, nx = q.shape
    ps = s.shape[1]
    c = probe_consts(h, m)
    f = {k: f32_scalar(getattr(c, k))
         for k in ("radius_sq", "w_h_inv", "w_norm", "w_norm_grad", "mass")}
    sp_ = torch.nn.functional.pad(s, (1, 1, 1, 1))
    qx, qy, qm = q[0], q[1], q[2] > 0.0
    accs = [torch.zeros_like(qx) for _ in range(5)]
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            for j in range(ps):
                cx, cy, cm = (sp_[k, j, rows, cols] for k in range(3))
                dx, dy = cx - qx, cy - qy
                r_sq = dx * dx + dy * dy
                valid = qm & (cm > 0.0) & (r_sq <= f["radius_sq"]) & (r_sq > MIN_DISTANCE_SQ)
                qq = torch.sqrt(r_sq) * f["w_h_inv"]
                omq = torch.clamp(1.0 - qq, min=0.0)
                omq2 = omq * omq
                w = (f["w_norm"] * (omq2 * omq2)) * (qq + 0.25)
                mc = f["mass"] * (f["w_norm_grad"] * (omq * omq2))
                gx = torch.where(valid, mc * dx, 0.0)
                gy = torch.where(valid, mc * dy, 0.0)
                terms = (torch.where(valid, w, 0.0), gx, gy, gx * gx + gy * gy,
                         torch.where(valid, 1.0, 0.0))
                accs = [a + t for a, t in zip(accs, terms)]
    return torch.stack(accs)


def ctx_pass(q: torch.Tensor, s: torch.Tensor, h: float, m: float) -> torch.Tensor:
    """The probe's ctx pass: (5, P, ny, nx) sums W, m grad W (x, y),
    |m grad W|^2, count. K7 on CUDA tensors, the twin on CPU ones."""
    if q.device.type == "cpu":
        return ctx_pass_ref(q, s, h, m)
    if q.device.type != "cuda":
        raise ValueError(f"ctx_pass: unsupported device {q.device}")
    _, p, ny, nx = q.shape
    ps = s.shape[1]
    cuda_build.check_tensor(q, q.device, (3, p, ny, nx), torch.float32, "ctx_pass: q")
    cuda_build.check_tensor(s, q.device, (3, ps, ny, nx), torch.float32, "ctx_pass: s")
    ty, tx, threads, smem = tile_shape(p, ps, 0, False, ny, nx)
    out = torch.empty((5, p, ny, nx), dtype=torch.float32, device=q.device)
    err = cuda_build.library().probe_ctx(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), p, ps, ny, nx, ty, tx, threads, smem,
        probe_consts(h, m), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "probe_ctx")
    LAUNCHES["probe_ctx"] += 1
    return out


def k1_ctx_call(q: torch.Tensor, s: torch.Tensor, h: float, m: float):
    """A call of K1's `ctx` form (the DFSPH plane step's fluid -> boundary
    statement, ops/pair_reduce.py) on the probe's planes, with its geometry
    built once: the same five sums as the probe."""
    kernel = WendlandQuinticC2(h)

    def ctx_terms(dx, dy, r_sq, r, scalars, q_planes, s_planes):
        w = kernel.evaluate(r_sq, r)
        mgc = kernel.gradient_coefficient(r_sq, r) * m
        gx, gy = mgc * dx, mgc * dy
        return (w, gx, gy, gx * gx + gy * gy, torch.ones_like(r_sq))

    consts = cuda_build.PairConsts(radius_sq=h * h, w_h_inv=kernel._h_inv,
                                   w_norm=kernel._norm, w_norm_grad=kernel._norm_grad,
                                   mass=m)
    form = PairForm("ctx", 5, ctx_terms)
    qg = PlaneGeom(q[:2].contiguous(), q[2] > 0.0)
    sg = qg if s is q else PlaneGeom(s[:2].contiguous(), s[2] > 0.0)
    return lambda: pair_reduce(form, qg, sg, consts)


def agree(a: torch.Tensor, b: torch.Tensor, rtol: float = 1e-4) -> bool:
    """The probe's own check: per output, rtol 1e-4 plus 1e-5 of the output's
    largest magnitude (the two statements differ in operation order)."""
    ok = True
    for k in range(a.shape[0]):
        scale = max(1.0, float(b[k].abs().max()))
        ok &= bool(torch.allclose(a[k], b[k], rtol=rtol, atol=1e-5 * scale))
    return ok


def run_check(device="cuda"):
    """K7 against K1 `ctx` on the TPU probe's check inputs."""
    d = CHECK_SHAPE
    pos, mask = probe_inputs(d["ny"], d["nx"], d["p"], d["h"])
    q = probe_planes(pos, mask, device)
    out = ctx_pass(q, q, d["h"], d["m"])
    ref = k1_ctx_call(q, q, d["h"], d["m"])()
    if not agree(out, ref):
        raise SystemExit(f"K7 ctx pass != K1 ctx: max |diff| per output "
                         f"{(out - ref).abs().amax((1, 2, 3)).tolist()}")
    print(f"slot-major ctx probe (K7) == K1 ctx OK on {torch.device(device)}")
    return out, ref


def run_gpu(device="cuda", seed: int = 0) -> dict:
    """K7 and K1 `ctx` device times on the same inputs at the 1M band shape,
    and their agreement."""
    from ..utils.cuda_timing import graph_ms

    if torch.device(device).type != "cuda":
        raise SystemExit("the gpu mode times the card: it needs a CUDA device")
    d = GPU_SHAPE
    pos, mask = probe_inputs(d["ny"], d["nx"], d["p"], d["h"], seed)
    q = probe_planes(pos, mask, device)
    k1 = k1_ctx_call(q, q, d["h"], d["m"])
    out, ref = ctx_pass(q, q, d["h"], d["m"]), k1()
    ok = agree(out, ref)
    k7_ms = graph_ms(lambda: ctx_pass(q, q, d["h"], d["m"]))
    k1_ms = graph_ms(k1)
    print(f"planes {tuple(q.shape)} on {torch.cuda.get_device_name(q.device)}")
    print(f"K7 slot-major ctx pass: {k7_ms:.5f} ms for {d['ny']} rows")
    print(f"K1 ctx pass:            {k1_ms:.5f} ms for {d['ny']} rows")
    print(f"values agree: {ok}")
    if not ok:
        raise SystemExit("K7 ctx pass != K1 ctx at the gpu shape")
    return dict(k7_ms=k7_ms, k1_ms=k1_ms, pairs=int(out[4].sum()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", nargs="?", default="check", choices=("check", "gpu"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    return run_check(args.device) if args.mode == "check" else run_gpu(args.device)


if __name__ == "__main__":
    main()
