"""Roofline accounting of the plane DFSPH step on the card (PyTorch port of
tools/roofline.py), and the port's one copy of the counting rules (bytes,
operations, candidates, pairs) that chip_smoke.py's bounds use.

    python -m yasph2d_tpu_torch.tools.roofline [n_particles] [settle_steps]
        [--pair-dtype bfloat16|float32] [--device cuda|cpu]

Defaults: 1M particles, 100 settle steps, bfloat16 operands (the TPU tool's
and bench's default). It settles `DFSPHPlaneSolver` on the double dam-break
(scenes.py) and prints:
- live slots, and the checks of the settled state (drops, live, finite);
- live pairs per particle, fluid and boundary, from the count plane of K1's
  `ctx` form (the TPU tool's count-only passes);
- the candidate volume K1 runs through: 9 cells x Ps mask reads per live
  query (fewer at the grid edge), and the live candidates among them (query
  and source live in the 3x3 cells), each against the live pairs;
- per-pass floors of the step's six K1 forms: their float32 operations
  (5 per live candidate, OPS_PER_PAIR per pair, OPS_PER_QUERY per live query)
  at the data-sheet rate and at K6's measured rates (tools/vpu_probe.py; on
  the card only).
"""

import argparse
import time

import torch

from ..ops.dense_grid import f32_scalar
from ..ops.pair_reduce import pair_reduce
from ..ops.planes import PlaneGeom, from_planes
from . import vpu_probe

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores (FMA = 2)
SMS = 132  # streaming multiprocessors of the H100 SXM
# the SM clock at which the data-sheet FP32 rate holds: 128 FP32 lanes x 2
# (an FMA) x 132 SMs x 1.98 GHz = 67 TFLOP/s
SM_HZ = FP32_OPS_PER_S / (2 * 128 * SMS)
# thread instructions per clock per SM of each pipe, from NVIDIA's CUDA C++
# documentation, its table of arithmetic instruction throughput for compute
# capability 9.0: "32-bit floating-point add, multiply, multiply-add" 128
# (FADD), "compare, minimum, maximum" 64 (FSETP; FSEL, a select, has no row
# of its own and goes to the same ALU pipe); every SM dispatches one warp
# instruction a clock from each of its four schedulers, 128 thread
# instructions in all
PIPE_PER_CLOCK = {"fp32": 128, "alu": 64}
DISPATCH_PER_CLOCK = 128
SASS_PIPE = {"FADD": "fp32", "FSETP": "alu", "FSEL": "alu"}
# float32 operations per valid pair of each call form, counted from its term
# functor in csrc/pair_terms.cuh (probe_ctx from ProbeCtxTerm): every add,
# subtract, multiply, divide, min, max and select of the statement as one,
# and r = sqrt(r_sq) as one where the term reads r (ptxas drops it where it
# does not: ViscTerm with XsphCoef); per live query of its epilogue (K1);
# every live candidate adds 5 (dx, dy, r_sq)
OPS_PER_PAIR = {
    "ctx": 26, "ctx_post": 26, "visc_gravity": 14, "err_ki": 14, "delta_ki": 14,
    "corr_v": 13, "wcsph_density": 7, "wcsph_stat": 18, "wcsph_forces": 31,
    "dfsph_ctx": 27, "dfsph_stat": 27, "dfsph_div": 14, "dfsph_corr": 13,
    "dfsph_visc": 14, "probe_ctx": 22,
    # the physical viscosity forms: PhysCoef's 4 operations where XsphCoef has
    # 8; the viscosity terms (ViscTerm's 6 and the coefficient) read r for
    # lap W_visc(r) = norm_lapl (h - r), one sqrt more than with XSPH; the
    # forces terms read r for the pressure gradient with either coefficient
    "visc_gravity_phys": 11, "wcsph_forces_phys": 27, "dfsph_visc_phys": 11,
    # the unfused DFSPH plane step's passes: their fused forms' terms, no
    # epilogue
    "visc": 14, "div": 14, "corr": 13, "visc_phys": 11,
}
# K5's bf16 math mode (ops/pallas_pair.py): each float32 operation of the
# candidate and the term is followed by its rounding to bf16, counted as one
# more operation
BF16_OPS_FACTOR = 2
OPS_PER_QUERY = {"ctx_post": 15, "visc_gravity": 2, "visc_gravity_phys": 2, "err_ki": 8,
                 "delta_ki": 8, "corr_v": 8}
OPS_PER_SLOT_REBUCKET = 10  # cell coordinates and the move code of a live slot
DFSPH_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v")


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


# the padded WCSPH step's glue kernels (ops/slot_glue.py): bytes a slot reads
# where it is live (the density from the boundary pass's component 0, the
# accelerations its components 1 and 2) and writes; slot_kick_drift writes
# live slots only, the others every slot. A few float32 operations a slot:
# bytes bound them
GLUE_READ = {"slot_kick_drift": 24, "slot_density_tait": 8, "slot_accel_cfl": 24,
             "slot_kick": 16}
GLUE_WRITE = {"slot_kick_drift": 16, "slot_density_tait": 8, "slot_accel_cfl": 8,
              "slot_kick": 8}


def glue_bytes(name: str, mask, dead_loads: bool = False) -> int:
    """Bytes glue kernel `name` must move on the slots of `mask`: the mask in
    full, the reads of the live slots (every slot's with `dead_loads`:
    slot_density_tait on K3's outputs), the writes (slot_accel_cfl's 4-byte
    max too)."""
    n, live = mask.numel(), int(mask.sum())
    return (nbytes(mask) + GLUE_READ[name] * (n if dead_loads else live)
            + GLUE_WRITE[name] * (live if name == "slot_kick_drift" else n)
            + (4 if name == "slot_accel_cfl" else 0))


# the DFSPH pressure loops' glue kernels (ops/pressure_glue.py): bytes a
# slot reads and writes where it is live. slot_pressure_err reads the div
# sums, v, sgs, the densities or neighbour totals, alpha and k_sum and
# writes k_i and k_sum, and its 0-d total; slot_pressure_kick reads v, the
# corr sums, k and sgs and writes v. Both write in place, live slots only
# (every slot without `dead_zero`: K3's outputs)
PRESSURE_GLUE_READ = {"slot_pressure_err": 32, "slot_pressure_kick": 28}
PRESSURE_GLUE_WRITE = {"slot_pressure_err": 8, "slot_pressure_kick": 8}


def pressure_glue_bytes(name: str, mask, dead_zero: bool = True) -> int:
    """Bytes pressure glue kernel `name` must move on the slots of `mask`:
    the mask in full, the reads and writes of the live slots (of every slot
    without `dead_zero`), slot_pressure_err's 4-byte total."""
    n = mask.numel() if not dead_zero else int(mask.sum())
    return (nbytes(mask) + (PRESSURE_GLUE_READ[name] + PRESSURE_GLUE_WRITE[name]) * n
            + (4 if name == "slot_pressure_err" else 0))


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of the memory and FP32 times at the
    data-sheet rates."""
    mem_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")


def instruction_bound(counts: dict) -> tuple:
    """(bound_ms, what bounds it) of a kernel that executes `counts` thread
    instructions by SASS opcode: the larger of each pipe's instructions over
    its rate (PIPE_PER_CLOCK) and all of them over the dispatch rate, on SMS SMs
    at SM_HZ. The K6 mix probe's bound (its SASS: one FSETP, one FSEL and one
    FADD a step, tools/vpu_probe.py --sass)."""
    per_pipe = {}
    for op, n in counts.items():
        per_pipe[SASS_PIPE[op]] = per_pipe.get(SASS_PIPE[op], 0) + n
    times = {f"{pipe} pipe": n / (PIPE_PER_CLOCK[pipe] * SMS * SM_HZ)
             for pipe, n in per_pipe.items()}
    times["dispatch"] = sum(counts.values()) / (DISPATCH_PER_CLOCK * SMS * SM_HZ)
    what = max(times, key=times.get)
    return times[what] * 1e3, what


def pair_counts(q_pos, q_mask, s_pos, s_mask, radius_sq, rebase_cell=None, rebase=None):
    """(live candidates, valid pairs) of a pair pass in the slot layout
    ((ny, nx, P[, 2])): query live and source live in the 3x3 cells, and
    1e-10 < r_sq <= h^2. With `rebase_cell` the positions are K1's bf16
    cell-relative geometry and each view adds its centre offset, as K1 does;
    with a `rebase` (K5's bf16 math mode) the pass's valid pairs are counted
    by its twin's bf16 test (`radius_sq` then the bf16 one)."""
    if rebase is not None:
        return _bf16_pair_counts(q_pos, q_mask, s_pos, s_mask, radius_sq, rebase)
    ny, nx, _ = q_mask.shape

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0) * (a.ndim - 2) + (1, 1, 1, 1))

    q_pos = q_pos.to(torch.float32)
    sp, sm = pad(s_pos.to(torch.float32).contiguous()), pad(s_mask.contiguous())
    delta = None if rebase_cell is None else (
        f32_scalar(-rebase_cell), 0.0, f32_scalar(rebase_cell))
    cand = valid = 0
    for dyv in range(3):
        for dxv in range(3):
            rows, cols = slice(dyv, dyv + ny), slice(dxv, dxv + nx)
            live = q_mask[..., None] & sm[rows, cols, None, :]
            d = sp[rows, cols, None, :, :] - q_pos[..., None, :]
            if delta is not None:
                d = d + torch.tensor([delta[dxv], delta[dyv]], device=d.device)
            r_sq = (d * d).sum(-1)
            cand += int(live.sum())
            valid += int((live & (r_sq <= radius_sq) & (r_sq > 1e-10)).sum())
    return cand, valid


def _bf16_pair_counts(q_pos, q_mask, s_pos, s_mask, radius_sq, rebase):
    """`pair_counts` in K5's bf16 math mode: the twin's pair test on its
    valid-pair count (a pass whose term counts 1 a pair)."""
    from ..ops.pallas_pair import pallas_pair_reduce_ref

    def count(dx, dy, r_sq, r, scalars, q, s):
        return (torch.ones_like(r_sq),)

    valid = pallas_pair_reduce_ref(count, 1, q_pos, q_mask, s_pos, s_mask, radius_sq,
                                   rebase=rebase)
    return pair_counts(q_pos, q_mask, s_pos, s_mask, 0.0)[0], int(valid.sum())


def plane_pairs(q: PlaneGeom, s: PlaneGeom):
    """A K1 call's geometry in the slot layout, for `pair_counts`."""
    return from_planes(q.pos), from_planes(q.mask), from_planes(s.pos), from_planes(s.mask)


def mask_reads(q: PlaneGeom, s: PlaneGeom) -> int:
    """Source mask reads of a K1 pass: per live query, Ps per in-grid cell of
    its 3x3 neighbourhood."""
    _, ny, nx = q.mask.shape
    ps = s.mask.shape[0]
    ones = torch.ones((1, 1, ny, nx), device=q.mask.device)
    cells = torch.nn.functional.conv2d(ones, torch.ones((1, 1, 3, 3), device=ones.device),
                                       padding=1)[0, 0]
    return int((q.mask.to(torch.float32) * cells).sum()) * ps


def pass_counts(q: PlaneGeom, s: PlaneGeom, radius_sq: float) -> dict:
    """Mask reads, live candidates and valid pairs of one K1 pass."""
    cand, pairs = pair_counts(*plane_pairs(q, s), radius_sq, q.rebase_cell)
    return dict(mask_reads=mask_reads(q, s), candidates=cand, pairs=pairs)


def form_ops(form: str, candidates: int, pairs: int, live: int) -> int:
    """Float32 operations of one call of a pair form."""
    return 5 * candidates + OPS_PER_PAIR[form] * pairs + OPS_PER_QUERY.get(form, 0) * live


def settle(n_particles: int, steps: int, pair_dtype: str, device):
    """(world, solver, boundary, carry, diagnostics) of the plane DFSPH step
    after init_carry + `steps` steps of the double dam-break."""
    from ..scenes import bench_solver, double_dam_break

    world = double_dam_break(n_particles)
    solver, boundary = bench_solver("dfsph_plane", world, device, pair_dtype=pair_dtype)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, diags = solver.simulate(carry, boundary, steps)
    return world, solver, boundary, carry, diags


def roofline(n_particles: int = 1_000_000, steps: int = 100, pair_dtype: str = "bfloat16",
             device="cuda", rates=None, log=print) -> dict:
    """Settle, count and print the roofline block; returns its numbers.
    `rates` ({name: operations/s}) adds floors at measured rates."""
    t0 = time.perf_counter()
    world, solver, boundary, carry, diags = settle(n_particles, steps, pair_dtype, device)
    t_settle = time.perf_counter() - t0
    ctx, grid = carry.ctx, solver.grid
    geom = ctx.geom
    n_live = int(ctx.mask.sum())
    s = solver.export_state(carry)
    alive = s.alive
    finite = bool(torch.isfinite(s.positions[alive]).all()
                  and torch.isfinite(s.velocities[alive]).all()
                  and torch.isfinite(s.densities[alive]).all())
    dens = s.densities[alive]
    # live pairs from the count plane (output 4) of K1's ctx form
    pairs_fluid, pairs_wall = (
        float(pair_reduce(solver._forms.ctx, geom, src, solver._consts)[4].sum())
        for src in (geom, boundary.geom))
    fluid = pass_counts(geom, geom, grid.radius_sq)
    wall = pass_counts(geom, boundary.geom, grid.radius_sq)
    out = dict(
        fluid=world.num_dynamic_particles, live=n_live, drops=int(diags.neighbor_drops),
        finite=finite, density_min=float(dens.min()), density_max=float(dens.max()),
        settle_s=t_settle, pairs_fluid=pairs_fluid, pairs_wall=pairs_wall,
        counts_fluid=fluid, counts_wall=wall, floors={})
    log("=== roofline inputs ===")
    log(f"scene: {world.num_dynamic_particles} fluid, settle {steps} steps "
        f"({t_settle:.2f} s), grid {grid.nx}x{grid.ny} occ {grid.occupancy}, "
        f"pair_dtype {grid.pair_dtype}, device {torch.device(device)}")
    log(f"settled state: drops {out['drops']}, live {n_live}, finite {finite}, "
        f"density [{out['density_min']!r}, {out['density_max']!r}]")
    log(f"live slots: {n_live} of {ctx.mask.numel()}")
    log(f"live pairs/particle: fluid {pairs_fluid / n_live:.2f}, "
        f"boundary {pairs_wall / n_live:.2f}")
    log(f"live pairs: fluid {pairs_fluid:.4e}, boundary {pairs_wall:.4e} "
        f"(pair_counts: {fluid['pairs']:.4e}, {wall['pairs']:.4e})")
    for name, c in (("fluid", fluid), ("boundary", wall)):
        log(f"candidates/pass {name}: mask reads {c['mask_reads']:.4e} (live-pair "
            f"fraction {c['pairs'] / max(c['mask_reads'], 1) * 100:.2f}%), live "
            f"candidates {c['candidates']:.4e} "
            f"({c['pairs'] / max(c['candidates'], 1) * 100:.2f}%)")
    all_rates = {"data sheet 67 TFLOP/s": FP32_OPS_PER_S, **(rates or {})}
    log("=== per-pass floors (float32 operations over each rate) ===")
    for form in DFSPH_FORMS:
        c = wall if form == "ctx" else fluid
        ops = form_ops(form, c["candidates"], c["pairs"], n_live)
        floors = {name: ops / rate * 1e3 for name, rate in all_rates.items()}
        out["floors"][form] = dict(ops=ops, **floors)
        log(f"{form}: {ops:.4e} ops -> " + ", ".join(
            f"{ms:.5f} ms at {name}" for name, ms in floors.items()))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_particles", nargs="?", type=int, default=1_000_000)
    parser.add_argument("settle_steps", nargs="?", type=int, default=100)
    parser.add_argument("--pair-dtype", default="bfloat16", choices=("bfloat16", "float32"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    rates = None
    if device.type == "cuda":
        # K6's rates as operations/s: an FMA counts 2, a mix instruction 1
        r = vpu_probe.measure(device)
        rates = {"K6 fma x8": r["fma8_tflops"] * 1e12, "K6 mix x8": r["mix_tvecops"] * 1e12}
    else:
        print("(K6 rates are measured on the card only: floors at the data sheet)")
    return roofline(args.n_particles, args.settle_steps, args.pair_dtype, device, rates)


if __name__ == "__main__":
    main()
