"""Where the time of the tiled pair kernels K1, K3, K5 and K7 goes, phase by
phase, on one GPU (the card's hosts have no ncu or nsys, and torch.profiler
times whole kernels only).

    python -m yasph2d_tpu_torch.tools.k1_phases [--kind dfsph_plane]
        [--particles 100000] [--steps 60]

Builds truncated copies of the kernel's source (csrc/pair_reduce.cuh for a
plane kind, K1, and for `--kind probe_ctx`, K7; csrc/tile_pair_reduce.cu for
a padded kind: K3 on dfsph_padded or wcsph_padded, K5 on dfsph_padded_k5 or
wcsph_padded_k5), each ending its blocks after one phase of the kernel, and
times them beside the full kernel on the same operands (the step's calls on
a settled double dam-break state, as tools/kernel_times.py builds them; K7
on the probe's planes at its gpu shape, tools/probe_pallas_slotmajor.py):
`scan` stops after the live-query scan and the dead slots' zeros, `staged`
after the source tile is staged, `full` is the kernel itself. The
differences are the phases' shares. Device milliseconds per call (10 calls
in a CUDA graph, CUDA events, median of 7). Needs a CUDA device and nvcc;
the copies go to build/yasph2d_tpu_torch/. Prints one JSON line.
"""

import argparse
import ctypes
import json

import numpy as np
import torch

# source: (file in csrc/ that is compiled, file in csrc/ that is cut, {variant:
# (line of the cut file, the statement inserted after it)}); "k1" holds K1 and
# K7, "tile" K3 and K5
CUTS = {
    "k1": ("pair_reduce.cu", "pair_reduce.cuh", {
        "scan": ("  if (n_live == 0) return;  // uniform across the block: an air tile",
                 "  return;"),
        "staged": ("  // the live queries, one per thread, in slot order", "  return;"),
    }),
    "tile": ("tile_pair_reduce.cu", "tile_pair_reduce.cu", {
        "scan": ("    __syncthreads();   // the list is complete", "    return;"),
        "staged": ("    // the live queries, one per thread, in slot order", "    return;"),
    }),
}


def build_variant(kernel: str, name: str):
    """Compile the source `kernel` of CUTS cut after the phase `name` into its
    own library and load it with its launchers' signatures."""
    from yasph2d_tpu_torch.ops import cuda_build

    unit, source, cuts = CUTS[kernel]
    anchor, stmt = cuts[name]
    src = (cuda_build.CSRC / source).read_text()
    if src.count(anchor + "\n") != 1:
        raise RuntimeError(f"k1_phases: anchor of {name!r} not found once in {source}")
    out_dir = cuda_build.BUILD_DIR / "k1_phases" / f"{kernel}_{name}"
    out_dir.mkdir(parents=True, exist_ok=True)
    # the cut file beside a copy of the unit, whose quoted include finds it first
    (out_dir / source).write_text(src.replace(anchor + "\n", f"{anchor}\n{stmt}\n"))
    cu = out_dir / unit
    if unit != source:
        cu.write_text((cuda_build.CSRC / unit).read_text())
    lib_path = out_dir / f"lib{kernel}_{name}.so"
    cuda_build._run_all([[cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(cuda_build.CSRC), "-shared", "-o", str(lib_path), str(cu)]])
    lib = ctypes.CDLL(str(lib_path))
    ref = cuda_build.library()
    names = ([f"tile_pair_reduce_{f}" for f in cuda_build.TILE_PAIR_FORMS]
             + [f"sm_pair_reduce_{f}" for f in cuda_build.SM_PAIR_FORMS]) if kernel == "tile" \
        else [f"pair_reduce_{f}{x}" for f in cuda_build.PAIR_FORMS for x in ("", "_bf16")] \
        + ["probe_ctx"]
    for fname in names:
        fn, model = getattr(lib, fname), getattr(ref, fname)
        fn.argtypes, fn.restype = model.argtypes, model.restype
    return lib


def padded_runs(solver, boundary, carry) -> dict:
    """{label: function of no argument} of a padded step's K3 or K5 calls,
    launched uncounted with the wrapper's tile."""
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops import sm_pair_reduce as smp
    from yasph2d_tpu_torch.tools.kernel_times import padded_calls

    launch = smp.launch if solver.grid.use_pallas_slotmajor else tpp.launch
    runs = {}
    for label, (form, q, s, kw) in padded_calls(
            solver, boundary, carry, np.random.default_rng(0)).items():
        tile = tpp.tile_shape(q[1].shape[2], s[1].shape[2],
                              len(tpp._comps(kw.get("s_vals", ()))))
        runs[label] = (lambda form=form, q=q, s=s, kw=kw, tile=tile: launch(
            form, *q, *s, solver._consts, kw.get("q_vals", ()), kw.get("s_vals", ()),
            kw.get("scalars", ()), tile))
    return runs


def plane_runs(solver, boundary, carry) -> dict:
    """{label: function of no argument} of a plane step's K1 calls, launched
    uncounted with the wrapper's tile."""
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.tools.kernel_times import plane_calls

    runs = {}
    for label, (form, q, s, kw) in plane_calls(
            solver, boundary, carry, np.random.default_rng(0)).items():
        tile = pr.tile_shape(q.mask.shape[0], s.mask.shape[0],
                             len(pr._planes(kw.get("s_vals", ()))),
                             q.rebase_cell is not None, *q.mask.shape[1:])
        runs[label] = (lambda form=form, q=q, s=s, kw=kw, tile=tile: pr.launch(
            form, q, s, solver._consts, kw.get("q_vals", ()), kw.get("s_vals", ()),
            kw.get("scalars", ()), kw.get("post_planes", ()), tile[:3]))
    return runs


def main(argv=None):
    from yasph2d_tpu_torch.ops import cuda_build
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools import probe_pallas_slotmajor as pc
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="dfsph_plane",
                    help="a solver of scenes.SOLVERS, or probe_ctx (K7)")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases needs a CUDA device")
    device = torch.device("cuda", 0)

    if args.kind == "probe_ctx":
        kernel = "k1"
        d = pc.GPU_SHAPE
        q = pc.probe_planes(*pc.probe_inputs(d["ny"], d["nx"], d["p"], d["h"]), device)
        runs = {"probe_ctx": lambda: pc.ctx_pass(q, q, d["h"], d["m"])}
        live = int((q[2] > 0).sum())
    else:
        world = double_dam_break(args.particles)
        solver, boundary = bench_solver(args.kind, world, device=device)
        carry = solver.init_carry(world.initial_state(device=device), boundary)
        carry, _ = solver.simulate(carry, boundary, args.steps)
        padded = "padded" in args.kind
        kernel = "tile" if padded else "k1"
        runs = (padded_runs if padded else plane_runs)(solver, boundary, carry)
        mask = (carry.ctx.mask if hasattr(carry, "ctx") else carry.mask)
        live = int(mask.sum())
    libs = {"full": cuda_build.library(),
            **{n: build_variant(kernel, n) for n in CUTS[kernel][2]}}
    rows = {}
    for label, run in runs.items():
        row = {}
        for name, lib in libs.items():
            cuda_build.library = lambda lib=lib: lib  # the launchers look it up per call
            row[name] = graph_ms(run)
        cuda_build.library = lambda: libs["full"]
        rows[label] = row
        print(f"{label:14s} " + " ".join(f"{k} {v:.5f}" for k, v in row.items()), flush=True)
    print(json.dumps({"kind": args.kind, "particles": args.particles, "steps": args.steps,
                      "live": live, "device": torch.cuda.get_device_name(0), "ms": rows}))


if __name__ == "__main__":
    main()
