"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. environment: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels (yasph2d_tpu_torch/csrc) with nvcc, one
     process per source, all started together;
  3. kernels: each kernel against its plain PyTorch twin on the same CUDA
     tensors, at the 100k double dam-break shapes: the nine call forms of the
     pair kernel K1 and the re-bucket K2 on the plane states of the DFSPH and
     WCSPH steps; the eight forms of the slot-major pair kernel K3 (three
     WCSPH, five DFSPH) and the slot-major re-bucket K4 with the WCSPH (D = 2)
     and DFSPH (D = 4) payloads on the padded states; the seven forms of the
     tiled pair kernel K5 (four DFSPH, three WCSPH) on the padded states of its
     route. The WCSPH states are taken after 3 steps, the DFSPH states after
     60, when the columns touch the walls and every fluid -> boundary pass
     must sum something. Pair forms agree to rtol 1e-5 plus 1e-6 of each
     output component's largest live magnitude; the re-buckets bit-equal,
     with and without forced cell overflow. `ms` is the kernel's device time:
     10 wrapper calls captured in a CUDA graph, each replay timed with CUDA
     events, median of 7, over 10; `plain_ms` the twin's, eager, CUDA events,
     median of 7. `bound_ms` is the larger of the bytes the call must move
     over 3.35 TB/s and its float32 operations (counted from the live
     candidate and valid pair counts of these inputs) over 67 TFLOP/s, the
     H100 SXM's data-sheet rates. The bytes: every mask read once in full,
     positions and values only of the slots that can change the result
     (live queries; live sources in the 3x3 cells of a live query; the live
     slots a re-bucket moves), every output written once in full. No single
     PyTorch call computes a pair reduction or a re-bucket, so `library_ms`
     is null;
  4. small reference: a 3k-particle scene stepped through the kernels on the
     GPU and through the twins on the CPU must agree, for every main path:
     5 steps from rest, and for the DFSPH paths 5 more from the GPU's state
     after 55 steps, where the columns touch the walls, the divergence loop
     iterates and warm-starts, and the fluid -> boundary pass sums something;
  5. main paths: init_carry + 20 steps of the 100k double dam-break through the
     kernels, for each solver and route of PATHS, with the launch count of
     every kernel of that path > 0, no dropped particle, all 99,372 particles
     live, finite state and densities in [rho0, 1.3 rho0] (the columns are
     still falling; after the impact, by step 60, the densest particle of the
     DFSPH plane step reaches 1.55 rho0, so phases 3 and 4 check the contact
     regime instead).

The line before the last is the GPU's name and power limit as nvidia-smi
reports them, the one before that the per-kernel JSON record; the last line is
{"ok": true, "device": ...}. Any failed phase raises, exits non-zero and
prints no result. Imports nothing of JAX.
"""

import json
import subprocess
import time

import numpy as np
import torch

from yasph2d_tpu_torch.utils.cuda_timing import event_ms, graph_ms

STEPS = 20
N_FLUID = 99_372
WARMUP_STEPS = 3  # the WCSPH kernel states
CONTACT_STEPS = 60  # the DFSPH kernel states: the columns touch the walls
CONTACT_STEPS_3K = 55  # the same on the 3k scene of phase 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
CSRC = "yasph2d_tpu_torch/csrc/"
SOURCES = {
    "pair_reduce": CSRC + "pair_reduce.cu",
    "rebucket": CSRC + "rebucket.cu",
    "sm_pair_reduce": CSRC + "sm_pair_reduce.cu",
    "sm_rebucket": CSRC + "sm_rebucket.cu",
    "tile_pair_reduce": CSRC + "tile_pair_reduce.cu",
}
REPLACES = {
    "pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:821",  # pf_pair_reduce
    "rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1120",  # pf_rebucket
    "sm_pair_reduce": "yasph2d_tpu/ops/pallas_slotmajor.py:252",  # sm_pair_reduce
    "sm_rebucket": "yasph2d_tpu/ops/pallas_slotmajor.py:1263",  # sm_rebucket
    "tile_pair_reduce": "yasph2d_tpu/ops/pallas_pair.py:97",  # pallas_pair_reduce
}
DFSPH_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v")
WCSPH_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces")
DFSPH_SM_FORMS = ("dfsph_ctx", "dfsph_stat", "dfsph_div", "dfsph_corr", "dfsph_visc")
DFSPH_TILE_FORMS = ("dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc")
# the kernels each main path must launch
PATHS = {
    "dfsph_plane": [f"pair_reduce_{f}" for f in DFSPH_FORMS] + ["rebucket"],
    "wcsph_padded": [f"sm_pair_reduce_{f}" for f in WCSPH_FORMS] + ["sm_rebucket"],
    "wcsph_plane": [f"pair_reduce_{f}" for f in WCSPH_FORMS] + ["rebucket"],
    "dfsph_padded": [f"sm_pair_reduce_{f}" for f in DFSPH_SM_FORMS] + ["sm_rebucket"],
    "dfsph_padded_k5": [f"tile_pair_reduce_{f}" for f in DFSPH_TILE_FORMS]
    + ["sm_rebucket"],
    "wcsph_padded_k5": [f"tile_pair_reduce_{f}" for f in WCSPH_FORMS] + ["sm_rebucket"],
}
# float32 operations per valid pair of each call form, counted from its term
# functor in csrc/pair_terms.cuh (sqrt included), and per live query of its
# epilogue (K1); every live candidate adds 5 (dx, dy, r_sq)
OPS_PER_PAIR = {
    "ctx": 26, "ctx_post": 26, "visc_gravity": 15, "err_ki": 14, "delta_ki": 14,
    "corr_v": 13, "wcsph_density": 7, "wcsph_stat": 18, "wcsph_forces": 31,
    "dfsph_ctx": 27, "dfsph_stat": 27, "dfsph_div": 14, "dfsph_corr": 13,
    "dfsph_visc": 15,
}
OPS_PER_QUERY = {"ctx_post": 15, "visc_gravity": 2, "err_ki": 8, "delta_ki": 8,
                 "corr_v": 8}
OPS_PER_SLOT_REBUCKET = 10  # cell coordinates and the move code of a live slot


def log(msg):
    print(msg, flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def slot_bytes(t, need) -> int:
    """Bytes of the slots of `t` that `need` (a slot mask) selects."""
    assert t.numel() % need.numel() == 0, (t.shape, need.shape)
    return nbytes(t) // need.numel() * int(need.sum())


def pair_bytes(q_tensors, s_tensors, masks, outputs, q_mask, s_mask) -> int:
    """Bytes a pair call must move: every mask in full; positions and values
    of the live query slots, and of the live source slots in the 3x3 cells
    around a cell with a live query (no other slot can change the result);
    every output in full (dead slots are written as zeros). `q_mask` and
    `s_mask` are in the slot layout; a tensor read as query and as source
    counts each of its slots once."""
    occupied = q_mask.any(-1)[None, None].to(torch.float32)
    near = torch.nn.functional.max_pool2d(occupied, 3, stride=1, padding=1)[0, 0] > 0
    need = {}
    for ts, m in ((q_tensors, q_mask), (s_tensors, s_mask & near[..., None])):
        for t in ts:
            seen = need.get(t.data_ptr())
            need[t.data_ptr()] = (t, m if seen is None else seen[1] | m)
    distinct_masks = {m.data_ptr(): m for m in masks}.values()
    return (sum(slot_bytes(t, m) for t, m in need.values())
            + sum(nbytes(m) for m in distinct_masks) + sum(nbytes(o) for o in outputs))


def rebucket_bytes(pos, mask, values, outputs) -> int:
    """Bytes a re-bucket must move: the mask in full, positions and payload of
    the live slots, every output in full."""
    return (nbytes(mask) + slot_bytes(pos, mask) + slot_bytes(values, mask)
            + sum(nbytes(o) for o in outputs))


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the memory and FP32 times."""
    mem_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def pair_counts(q_pos, q_mask, s_pos, s_mask, radius_sq):
    """(live candidates, valid pairs) of a pair pass in the slot layout:
    query live and source live in the 3x3 cells, and within h."""
    ny, nx, _ = q_mask.shape

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    sp, sm = pad(s_pos.contiguous()), pad(s_mask.contiguous())
    cand = valid = 0
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            live = q_mask[..., None] & sm[rows, cols, None, :]
            d = sp[rows, cols, None, :, :] - q_pos[..., None, :]
            r_sq = (d * d).sum(-1)
            cand += int(live.sum())
            valid += int((live & (r_sq <= radius_sq) & (r_sq > 1e-10)).sum())
    return cand, valid


def role_tensors(q_pos, s_pos, kw):
    """(query-side, source-side) input tensors of a pair call: positions,
    values, and (K1) the epilogue's per-query planes."""
    q = [q_pos, *kw.get("q_vals", ()), *kw.get("post_planes", ())]
    return q, [s_pos, *kw.get("s_vals", ())]


def pair_error(kernel_out, twin_out, live, comp_dim):
    """(max abs error on live slots per output component, passes): rtol 1e-5
    plus 1e-6 of the component's largest live magnitude (at least 1), so a
    small component (a neighbour count) is not held to a large one's scale.
    `comp_dim` is the output's component axis, `live` the slot mask."""
    a = kernel_out.movedim(comp_dim, -1)[live]
    b = twin_out.movedim(comp_dim, -1)[live]
    if b.shape[0] == 0:
        return [0.0] * b.shape[1], bool(torch.isfinite(a).all())
    err = (a - b).abs()
    scale = b.abs().amax(0).clamp(min=1.0)
    ok = bool(torch.isfinite(a).all()) and bool((err <= 1e-5 * b.abs() + 1e-6 * scale).all())
    return err.amax(0).tolist(), ok


def bit_equal(outs_k, outs_t) -> bool:
    def bits(a):
        return a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
    return all(torch.equal(bits(a), bits(b)) for a, b in zip(outs_k, outs_t))


class Records:
    """The per-kernel JSON records; a kernel checked in several calls keeps
    the first (main-path) call's times and bound, and the largest error. A
    record's launches are its counter's counts on the main paths it lists
    (all paths when None)."""

    def __init__(self):
        self.by_name = {}
        self.nonzero = set()

    def add(self, name, kernel, max_abs_err, ms, plain_ms, n_bytes, n_ops,
            counter=None, paths=None):
        if name in self.by_name:
            rec = self.by_name[name]
            rec["max_abs_err"] = max(rec["max_abs_err"], max_abs_err)
            return
        bound_ms, bound_by = bound(n_bytes, n_ops)
        log(f"phase 3 kernels: {name} bound {bound_ms:.5f} ms by {bound_by} "
            f"({n_bytes} bytes, {n_ops} float32 operations), kernel {ms:.5f} ms, "
            f"{bound_ms / ms:.3f} of the bound")
        self.by_name[name] = dict(
            name=name, route="cuda", source=SOURCES[kernel], replaces=REPLACES[kernel],
            launches=0, max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            _counter=counter or name, _paths=paths)

    def check_pair(self, kernel, label, form, run_kernel, run_twin, live, comp_dim,
                   roles, masks, pairs, radius_sq):
        """`live`: the query slot mask, `comp_dim` the output's component
        axis; `roles`: the (query-side, source-side) input tensors and `masks`
        the input masks, for its bytes; `pairs`: (q_pos, q_mask, s_pos,
        s_mask) in the slot layout and the cutoff, for its needed slots and
        operation count."""
        out_k, out_t = run_kernel(), run_twin()
        torch.cuda.synchronize()
        errs, ok = pair_error(out_k, out_t, live, comp_dim)
        err = max(errs)
        nonzero = bool(out_t.movedim(comp_dim, -1)[live].abs().sum() > 0)
        name = f"{kernel}_{form.name}"
        if nonzero:
            self.nonzero.update((name, f"{kernel}_{label}"))
        log(f"phase 3 kernels: {kernel}_{label} max_abs_err {err!r} per component "
            f"{errs!r} {'ok' if ok else 'MISMATCH'} nonzero {nonzero}")
        if not ok:
            raise RuntimeError(f"{kernel}_{label} disagrees with its twin "
                               f"(max_abs_err per component {errs})")
        if name in self.by_name:
            self.by_name[name]["max_abs_err"] = max(self.by_name[name]["max_abs_err"], err)
            return
        ms, plain_ms = graph_ms(run_kernel), event_ms(run_twin)
        cand, valid = pair_counts(*pairs, radius_sq)
        n_live = int(pairs[1].sum())
        n_ops = 5 * cand + OPS_PER_PAIR[form.name] * valid \
            + OPS_PER_QUERY.get(form.name, 0) * n_live
        log(f"phase 3 kernels: {kernel}_{label} kernel {ms:.5f} ms twin {plain_ms:.4f} ms, "
            f"{n_live} live queries, {cand} live candidates, {valid} valid pairs")
        n_bytes = pair_bytes(*roles, masks, [out_k], pairs[1], pairs[3])
        self.add(name, kernel, err, ms, plain_ms, n_bytes, n_ops)

    def check_rebucket(self, kernel, label, run_kernel, run_twin, overflow, inputs,
                       name=None, paths=None):
        """`inputs`: the call's (positions, mask, payload)."""
        out_k, out_t = run_kernel(), run_twin()
        torch.cuda.synchronize()
        equal = bit_equal(out_k, out_t)
        drops = int(out_k[3])
        log(f"phase 3 kernels: {kernel}[{label}] bit-equal {equal} drops {drops} "
            f"live {int(out_k[1].sum())}")
        if not equal:
            raise RuntimeError(f"{kernel}[{label}] is not bit-equal to its twin")
        if overflow and drops == 0:
            raise RuntimeError(f"{kernel}[{label}] forced no drops")
        if not overflow:
            if drops != 0:
                raise RuntimeError(f"{kernel}[{label}] dropped particles")
            ms, plain_ms = graph_ms(run_kernel), event_ms(run_twin)
            log(f"phase 3 kernels: {kernel}[{label}] kernel {ms:.5f} ms twin "
                f"{plain_ms:.4f} ms")
            n_ops = OPS_PER_SLOT_REBUCKET * int(inputs[1].sum())
            self.add(name or kernel, kernel, 0.0, ms, plain_ms,
                     rebucket_bytes(*inputs, out_k), n_ops, counter=kernel, paths=paths)

    def require_nonzero(self, names):
        """Each of `names` (a form, or a form's call by its label) produced a
        nonzero live output."""
        idle = set(names) - self.nonzero
        if idle:
            raise RuntimeError(f"pair forms never produced a nonzero live output: {idle}")


def moving_state(kind, device, steps):
    """A 100k state in motion: init_carry + `steps` steps."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    world = double_dam_break(100_000)
    solver, boundary = bench_solver(kind, world, device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, steps)
    torch.cuda.synchronize()
    return solver, boundary, carry


def phase_environment():
    if not torch.cuda.is_available():
        raise SystemExit("phase 1 environment: FAILED, torch.cuda.is_available() is false")
    nvcc = subprocess.run(["nvcc", "--version"], capture_output=True, text=True)
    nvcc_version = (nvcc.stdout.strip().splitlines() or ["nvcc not found"])[-1]
    log(f"phase 1 environment: {gpu_line()} | torch {torch.__version__} | "
        f"CUDA {torch.version.cuda} | {nvcc_version} | "
        f"devices {torch.cuda.device_count()}")


def phase_build():
    from yasph2d_tpu_torch.ops import cuda_build

    fresh = not cuda_build.library_path().exists()
    t0 = time.perf_counter()
    path = cuda_build.build()
    t_build = time.perf_counter() - t0
    cuda_build.library()
    log(f"phase 2 build: {path.name} {'nvcc' if fresh else 'already built,'} "
        f"{t_build:.2f} s, load {time.perf_counter() - t0 - t_build:.2f} s")


def plane_pairs(q, s):
    """A K1 call's geometry in the slot layout, for its operation count."""
    from yasph2d_tpu_torch.ops.planes import from_planes

    return from_planes(q.pos), from_planes(q.mask), from_planes(s.pos), from_planes(s.mask)


def phase_kernels_dfsph(device, rec: Records):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb

    solver, boundary, carry = moving_state("dfsph_plane", device, CONTACT_STEPS)
    ctx = carry.ctx
    geom = ctx.geom
    dt = float(carry.time.dt)
    m = np.float32(solver.properties.particle_mass)
    scale = float((np.float32(1.0) / np.float32(dt)) * m)
    f = solver._forms
    # (label, form, source geometry, keyword operands) as the step calls them;
    # the ctx instantiation is also checked fluid -> fluid, where every live
    # slot has neighbours.
    stat = pr.pair_reduce(f.ctx, geom, boundary.geom, solver._consts)
    # most of the fluid is still a barely compressed lattice whose slots have
    # fewer than the 9 neighbours the divergence guard asks for: seeded
    # velocity, stiffness and neighbour-count noise makes the loop forms do
    # real work on every live slot
    rng = np.random.default_rng(0)
    nt = torch.as_tensor(
        np.floor(rng.uniform(0.0, 18.0, tuple(ctx.neighbor_total.shape))).astype(np.float32),
        device=device)
    v = carry.v + torch.as_tensor(
        rng.normal(0.0, 0.5, tuple(carry.v.shape)).astype(np.float32), device=device)
    k = torch.as_tensor(
        rng.normal(0.0, 50.0, tuple(carry.kappa.shape)).astype(np.float32), device=device)
    calls = [
        ("ctx[boundary]", f.ctx, boundary.geom, {}),
        ("ctx[fluid->fluid]", f.ctx, geom, {}),
        ("ctx_post", f.ctx_post, geom, dict(post_planes=(stat,))),
        ("visc_gravity", f.visc_gravity, geom, dict(
            q_vals=(v,), s_vals=(v, ctx.densities), scalars=(dt,))),
        ("err_ki", f.err_ki, geom, dict(
            q_vals=(v,), s_vals=(v,), scalars=(dt,),
            post_planes=(v, ctx.sum_grad_stat, ctx.densities, ctx.alpha))),
        ("delta_ki", f.delta_ki, geom, dict(
            q_vals=(v,), s_vals=(v,),
            post_planes=(v, ctx.sum_grad_stat, nt, ctx.alpha))),
        ("corr_v", f.corr_v, geom, dict(
            q_vals=(k,), s_vals=(k,), scalars=(scale,),
            post_planes=(v, k, ctx.sum_grad_stat))),
    ]
    for label, form, src, kw in calls:
        rec.check_pair(
            "pair_reduce", label, form,
            lambda: pr.pair_reduce(form, geom, src, solver._consts, **kw),
            lambda: pr.pair_reduce_ref(
                form.term_fn, form.n_out, geom, src, solver._consts.radius_sq,
                post_fn=form.post_fn, n_acc=form.n_acc, **kw),
            ctx.mask, 0, role_tensors(geom.pos, src.pos, kw), [geom.mask, src.mask],
            plane_pairs(geom, src), solver._consts.radius_sq)
    rec.require_nonzero([f"pair_reduce_{n}" for n in DFSPH_FORMS]
                        + ["pair_reduce_ctx[boundary]"])

    # re-bucket: the step's own advection, and a forced overflow in which every
    # particle of an odd cell column moves one cell left
    grid = solver.grid
    pos = ctx.pos + carry.v * dt
    extra = torch.cat([carry.v, carry.kappa[None], carry.stiff[None]], dim=0)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = pos.clone()
    crowded[0] -= odd * grid.cell_size
    for label, p in (("advect", pos), ("overflow", crowded)):
        rec.check_rebucket("rebucket", label,
                           lambda: rb.rebucket(p, ctx.mask, extra, grid),
                           lambda: rb.rebucket_ref(p, ctx.mask, extra, grid),
                           overflow=label == "overflow", inputs=[p, ctx.mask, extra])


def noise(t, scale, rng):
    return torch.as_tensor(rng.normal(0.0, scale, tuple(t.shape)).astype(np.float32),
                           device=t.device)


def wcsph_operands(solver, live, v_live, v, dens, rng):
    """Forces-pass operands of a WCSPH state: the barely compressed early state
    has rho = rho0 and p = 0 everywhere, so seeded density (up) and velocity
    noise on live slots gives the pressure and viscosity terms real work."""
    from yasph2d_tpu_torch.models.wcsph import tait_pressure

    rho0 = solver.properties.fluid_density
    dens = torch.where(live, dens + noise(dens, 0.05 * rho0, rng).abs(), dens)
    v = torch.where(v_live, v + noise(v, 0.5, rng), v)
    return tait_pressure(solver.stiffness, rho0, dens), dens, v


def check_slot_calls(rec, kernel, calls, pos, mask, consts):
    """K3 or K5 call forms on one padded state against their twins."""
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp

    run, ref = {"sm_pair_reduce": (smp.sm_pair_reduce, smp.sm_pair_reduce_ref),
                "tile_pair_reduce": (tpp.pallas_pair_reduce,
                                     tpp.pallas_pair_reduce_ref)}[kernel]
    for label, form, (s_pos, s_mask), kw in calls:
        rec.check_pair(
            kernel, label, form,
            lambda: run(form, pos, mask, s_pos, s_mask, consts, **kw),
            lambda: ref(form.term_fn, form.n_out, pos, mask, s_pos, s_mask,
                        consts.radius_sq, **kw),
            mask, -1, role_tensors(pos, s_pos, kw), [mask, s_mask],
            (pos, mask, s_pos, s_mask), consts.radius_sq)


def wcsph_slot_calls(solver, boundary, carry, rng):
    f = solver._forms
    dt = float(carry.time.dt)
    pos, mask = carry.pos_pad, carry.mask
    pres, dens, v = wcsph_operands(solver, mask, mask[..., None], carry.v_pad,
                                   carry.dens_pad, rng)
    fluid = (pos, mask)
    walls = (boundary.pos_pad, boundary.mask)
    return [
        ("wcsph_density", f.density, fluid, {}),
        ("wcsph_stat", f.stat, walls, {}),
        # the fluid -> boundary pass sums nothing before the columns reach the
        # walls: the same instantiation fluid -> fluid
        ("wcsph_stat[fluid->fluid]", f.stat, fluid, {}),
        ("wcsph_forces", f.forces, fluid, dict(
            q_vals=(pres, dens, v), s_vals=(pres, dens, v), scalars=(dt,))),
    ]


def phase_kernels_wcsph(device, rec: Records):
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import rebucket as rb
    from yasph2d_tpu_torch.ops import sm_rebucket as smr
    from yasph2d_tpu_torch.ops.planes import PlaneGeom

    rng = np.random.default_rng(1)

    # K3 and K4 (D = 2) on the padded state
    solver, boundary, carry = moving_state("wcsph_padded", device, WARMUP_STEPS)
    grid = solver.grid
    dt = float(carry.time.dt)
    pos, mask = carry.pos_pad, carry.mask
    check_slot_calls(rec, "sm_pair_reduce", wcsph_slot_calls(solver, boundary, carry, rng),
                     pos, mask, solver._consts)
    rec.require_nonzero([f"sm_pair_reduce_{n}" for n in WCSPH_FORMS])
    adv = pos + carry.v_pad * dt
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = adv.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    for label, p in (("advect", adv), ("overflow", crowded)):
        rec.check_rebucket("sm_rebucket", label,
                           lambda: smr.sm_rebucket(p, mask, carry.v_pad, grid),
                           lambda: smr.sm_rebucket_ref(p, mask, carry.v_pad, grid),
                           overflow=label == "overflow", inputs=[p, mask, carry.v_pad],
                           paths={"wcsph_padded", "wcsph_padded_k5"})

    # K5's WCSPH forms on the padded state of the K5 route
    solver, boundary, carry = moving_state("wcsph_padded_k5", device, WARMUP_STEPS)
    check_slot_calls(rec, "tile_pair_reduce",
                     wcsph_slot_calls(solver, boundary, carry, rng),
                     carry.pos_pad, carry.mask, solver._consts)
    rec.require_nonzero([f"tile_pair_reduce_{n}" for n in WCSPH_FORMS])

    # K1's WCSPH forms and K2 with the velocity payload on the plane state
    solver, boundary, carry = moving_state("wcsph_plane", device, WARMUP_STEPS)
    f, c = solver._forms, solver._consts
    dt = float(carry.time.dt)
    geom = PlaneGeom(carry.pos, carry.mask)
    pres, dens, v = wcsph_operands(solver, carry.mask, carry.mask[None], carry.v,
                                   carry.dens, rng)
    calls = [
        ("wcsph_density", f.density, geom, {}),
        ("wcsph_stat", f.stat, boundary.geom, {}),
        ("wcsph_stat[fluid->fluid]", f.stat, geom, {}),
        ("wcsph_forces", f.forces, geom, dict(
            q_vals=(pres, dens, v), s_vals=(pres, dens, v), scalars=(dt,))),
    ]
    for label, form, src, kw in calls:
        rec.check_pair(
            "pair_reduce", label, form,
            lambda: pr.pair_reduce(form, geom, src, c, **kw),
            lambda: pr.pair_reduce_ref(form.term_fn, form.n_out, geom, src,
                                       c.radius_sq, **kw),
            carry.mask, 0, role_tensors(geom.pos, src.pos, kw), [geom.mask, src.mask],
            plane_pairs(geom, src), c.radius_sq)
    rec.require_nonzero([f"pair_reduce_{n}" for n in WCSPH_FORMS])
    adv = carry.pos + carry.v * dt
    rec.check_rebucket("rebucket", "wcsph advect",
                       lambda: rb.rebucket(adv, carry.mask, carry.v, solver.grid),
                       lambda: rb.rebucket_ref(adv, carry.mask, carry.v, solver.grid),
                       overflow=False, inputs=[adv, carry.mask, carry.v])


def dfsph_slot_calls(solver, boundary, carry, rng):
    """The DFSPH padded step's pair calls on a state in wall contact, with
    seeded velocity and stiffness noise (most of the lattice barely
    compresses yet)."""
    f, ctx = solver._padded_forms, carry.ctx
    dt = float(carry.time.dt)
    mask = ctx.mask
    v = torch.where(mask[..., None], carry.v_pad + noise(carry.v_pad, 0.5, rng),
                    carry.v_pad)
    k = torch.where(mask, noise(carry.kappa_pad, 50.0, rng), 0.0)
    fluid = (ctx.pos_pad, mask)
    walls = (boundary.pos_pad, boundary.mask)
    stat = f.stat.name  # dfsph_stat on K3; K5 runs the boundary pass as dfsph_ctx
    return [
        ("dfsph_ctx", f.ctx, fluid, {}),
        (stat + "[boundary]", f.stat, walls, {}),
        # the boundary pass's instantiation on many more pairs
        (stat + "[fluid->fluid]", f.stat, fluid, {}),
        ("dfsph_div", f.div, fluid, dict(q_vals=(v,), s_vals=(v,))),
        ("dfsph_corr", f.corr, fluid, dict(q_vals=(k,), s_vals=(k,))),
        ("dfsph_visc", f.visc, fluid, dict(q_vals=(v,), s_vals=(v, ctx.densities_pad),
                                           scalars=(dt,))),
    ]


def phase_kernels_dfsph_padded(device, rec: Records):
    from yasph2d_tpu_torch.ops import sm_rebucket as smr

    rng = np.random.default_rng(2)

    # K3's five DFSPH forms and K4 (D = 4) on the padded state
    solver, boundary, carry = moving_state("dfsph_padded", device, CONTACT_STEPS)
    ctx, grid = carry.ctx, solver.grid
    check_slot_calls(rec, "sm_pair_reduce", dfsph_slot_calls(solver, boundary, carry, rng),
                     ctx.pos_pad, ctx.mask, solver._consts)
    rec.require_nonzero([f"sm_pair_reduce_{n}" for n in DFSPH_SM_FORMS]
                        + ["sm_pair_reduce_dfsph_stat[boundary]"])
    dt = float(carry.time.dt)
    adv = ctx.pos_pad + carry.v_pad * dt
    extra = torch.cat([carry.v_pad, carry.kappa_pad[..., None],
                       carry.stiff_pad[..., None]], dim=-1)
    odd = (torch.arange(grid.nx, device=device) % 2 == 1).to(torch.float32)
    crowded = adv.clone()
    crowded[..., 0] -= odd[None, :, None] * grid.cell_size
    for label, p in (("D=4 advect", adv), ("D=4 overflow", crowded)):
        rec.check_rebucket("sm_rebucket", label,
                           lambda: smr.sm_rebucket(p, ctx.mask, extra, grid),
                           lambda: smr.sm_rebucket_ref(p, ctx.mask, extra, grid),
                           overflow=label.endswith("overflow"),
                           inputs=[p, ctx.mask, extra], name="sm_rebucket_d4",
                           paths={"dfsph_padded", "dfsph_padded_k5"})

    # K5's four DFSPH forms on the padded state of the K5 route
    solver, boundary, carry = moving_state("dfsph_padded_k5", device, CONTACT_STEPS)
    check_slot_calls(rec, "tile_pair_reduce",
                     dfsph_slot_calls(solver, boundary, carry, rng),
                     carry.ctx.pos_pad, carry.ctx.mask, solver._consts)
    rec.require_nonzero([f"tile_pair_reduce_{n}" for n in DFSPH_TILE_FORMS]
                        + ["tile_pair_reduce_dfsph_ctx[boundary]"])


def live_rows(state):
    """(x, y, density) of the live particles, on the CPU, in slot order."""
    alive = state.alive
    return torch.cat([state.positions, state.densities[:, None]], dim=1)[alive].cpu()


def matched_rows(a, b):
    """The live rows of `b` reordered to match `a`'s, each row of `a` paired
    with the row of `b` nearest in position; None when that is not one to
    one. Slot order can differ between two runs and any sort key can tie
    (equal densities at rest, equal x in a falling column); two particles are
    never within 1e-5 of each other."""
    if a.shape != b.shape:
        return None
    j = torch.cdist(a[:, :2].double(), b[:, :2].double()).argmin(1)
    return b[j] if torch.unique(j).numel() == j.numel() else None


def to_device(tree, device):
    """A carry or boundary (nested named tuples of tensors) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        items = [to_device(v, device) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def run_steps(solver, carry, boundary, n):
    """(carry, [(density its, divergence its, drops) per step]) after n steps."""
    counts = []
    for _ in range(n):
        carry, d = solver.simulate(carry, boundary, 1)
        counts.append((d.density_iterations, d.divergence_iterations, d.neighbor_drops))
    return carry, counts


def phase_small_reference(device):
    """Kernels on the GPU against the twins on the CPU on a 3k scene: 5 steps
    from rest for every path, and for the DFSPH paths 5 more from the GPU's
    state in wall contact, copied to the CPU."""
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    sides = {"gpu": device, "cpu": torch.device("cpu")}
    for kind in PATHS:
        solvers = {side: bench_solver(kind, double_dam_break(3_000), dev)
                   for side, dev in sides.items()}
        starts = {"rest": {side: solvers[side][0].init_carry(
            double_dam_break(3_000).initial_state(device=dev), solvers[side][1])
            for side, dev in sides.items()}}
        if kind.startswith("dfsph"):
            solver, boundary = solvers["gpu"]
            carry, _ = run_steps(solver, starts["rest"]["gpu"], boundary, CONTACT_STEPS_3K)
            starts["contact"] = {"gpu": carry, "cpu": to_device(carry, sides["cpu"])}
        for start, carries in starts.items():
            runs = {}
            for side, carry in carries.items():
                solver, boundary = solvers[side]
                carry, counts = run_steps(solver, carry, boundary, 5)
                runs[side] = (counts, live_rows(solver.export_state(carry)), carry)
            (gc, grows, carry), (cc, crows, _) = runs["gpu"], runs["cpu"]
            crows = matched_rows(grows, crows)
            diff = None if crows is None else (grows - crows).abs().amax(0).tolist()
            log(f"phase 4 small reference: {kind} from {start}, {grows.shape[0]} particles, "
                f"(iterations, drops) gpu {gc} cpu {cc}, max |dx|, |dy|, |d density| "
                f"{diff!r}")
            # from rest both runs are bit-equal in practice; from contact, a
            # few ulps (K5 and its twin sum in other orders, the CPU's sqrt is
            # not correctly rounded) grow over the steps: the solver tolerances
            # of the CPU tests (positions atol 1e-5, densities rtol 1e-4 and
            # atol 1e-2)
            pos_rtol, rho_rtol, rho_atol = (1e-5, 1e-5, 1e-5) if start == "rest" \
                else (0.0, 1e-4, 1e-2)
            if gc != cc or crows is None or not (
                    torch.allclose(grows[:, :2], crows[:, :2], rtol=pos_rtol, atol=1e-5)
                    and torch.allclose(grows[:, 2], crows[:, 2], rtol=rho_rtol,
                                       atol=rho_atol)):
                raise RuntimeError(f"{kind}: GPU kernels and CPU twins disagree on the "
                                   f"small scene from {start}")
            if start == "contact":
                # a divergence loop of more than one iteration warm-starts the
                # next step's; the boundary pass found fluid -> wall pairs
                walls = float(carry.ctx.sum_grad_stat.abs().sum())
                log(f"phase 4 small reference: {kind} from contact, |sum grad W to the "
                    f"boundary| {walls!r}")
                if max(c[1] for c in gc[:-1]) <= 1 or walls == 0.0:
                    raise RuntimeError(f"{kind}: the contact state exercised no warm "
                                       "start or no fluid -> boundary pair")


def _kernel_modules():
    from yasph2d_tpu_torch.ops import (
        pair_reduce, pallas_pair, rebucket, sm_pair_reduce, sm_rebucket,
    )

    return {"pair_reduce": pair_reduce, "sm_pair_reduce": sm_pair_reduce,
            "tile_pair_reduce": pallas_pair, "rebucket": rebucket,
            "sm_rebucket": sm_rebucket}


def reset_launch_counts():
    for mod in _kernel_modules().values():
        mod.reset_launch_counts()


def launch_counts() -> dict:
    counts = {}
    for kernel, mod in _kernel_modules().items():
        for k, v in mod.LAUNCHES.items():
            counts[k if k == kernel else f"{kernel}_{k}"] = v
    return counts


def phase_main_path(device, kind) -> dict:
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break

    world = double_dam_break(100_000)
    assert world.num_dynamic_particles == N_FLUID, world.num_dynamic_particles
    solver, boundary = bench_solver(kind, world, device)
    grid = solver.grid
    state = world.initial_state(device=device)
    torch.cuda.synchronize()

    reset_launch_counts()
    t0 = time.perf_counter()
    carry = solver.init_carry(state, boundary)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    diags = []
    t0 = time.perf_counter()
    for _ in range(STEPS):
        carry, d = solver.simulate(carry, boundary, 1)
        diags.append(d)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()

    s = solver.export_state(carry)
    live = int(s.alive.sum())
    rho0 = solver.properties.fluid_density
    pos, vel, dens = s.positions[s.alive], s.velocities[s.alive], s.densities[s.alive]
    finite = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all()
                  and torch.isfinite(dens).all())
    dmin, dmax = float(dens.min()), float(dens.max())
    drops = max(d.neighbor_drops for d in diags)
    ms = elapsed / STEPS * 1e3
    log(f"phase 5 main path [{kind}]: grid {grid.nx}x{grid.ny} P {grid.occupancy}, "
        f"{live} live / {world.num_boundary_particles} boundary, init {t_init:.3f} s, "
        f"{STEPS} steps {ms:.3f} ms/step {live * STEPS / elapsed:.1f} particle-steps/s, "
        f"drops {drops}, density [{dmin!r}, {dmax!r}], dt {float(carry.time.dt)!r}, "
        f"max |v| {float(max(d.max_velocity for d in diags))!r}")
    if kind.startswith("dfsph"):
        iters = [(d.density_iterations, d.divergence_iterations) for d in diags]
        log(f"phase 5 main path [{kind}]: iterations per step (density, divergence) "
            f"{iters}")
    path = {k: launches[k] for k in PATHS[kind]}
    log(f"phase 5 main path [{kind}]: launches {path}")
    problems = [k for k, v in path.items() if v <= 0]
    if problems:
        raise RuntimeError(f"{kind}: kernels never launched on the main path: {problems}")
    if drops != 0 or live != N_FLUID or not finite:
        raise RuntimeError(f"{kind}: main path state wrong: drops {drops} live {live} "
                           f"finite {finite}")
    if not (rho0 <= dmin and dmax <= 1.3 * rho0):
        raise RuntimeError(f"{kind}: densities outside [rho0, 1.3 rho0]: [{dmin}, {dmax}]")
    return path


def main():
    phase_environment()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    rec = Records()
    phase_kernels_dfsph(device, rec)
    phase_kernels_wcsph(device, rec)
    phase_kernels_dfsph_padded(device, rec)
    phase_small_reference(device)
    path_launches = {kind: phase_main_path(device, kind) for kind in PATHS}
    records = list(rec.by_name.values())
    for r in records:
        counter, paths = r.pop("_counter"), r.pop("_paths")
        r["launches"] = sum(counts.get(counter, 0) for kind, counts in path_launches.items()
                            if paths is None or kind in paths)
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        raise RuntimeError(f"kernels of the JSON record never launched on a main path: "
                           f"{missing}")
    print(json.dumps({"kernels": records}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
