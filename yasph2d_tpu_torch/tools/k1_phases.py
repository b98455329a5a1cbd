"""Where the time of the tiled pair kernels K1 and K5 goes, phase by phase, on
one GPU (the card's hosts have no ncu or nsys, and torch.profiler times whole
kernels only).

    python -m yasph2d_tpu_torch.tools.k1_phases [--kind dfsph_plane]
        [--particles 100000] [--steps 60]

Builds truncated copies of the kernel's source (csrc/pair_reduce.cu for a
plane kind, csrc/tile_pair_reduce.cu, K5, for a padded kind on its K5 route,
dfsph_padded_k5 or wcsph_padded_k5), each ending its blocks after one phase
of the kernel, and times them beside the full kernel on the same operands
(the step's calls on a settled double dam-break state, as
tools/kernel_times.py builds them): `scan` stops after the live-query scan
and the dead slots' zeros, `staged` after the source tile is staged, `full`
is the kernel itself. The differences are the phases' shares. Device
milliseconds per call (10 calls in a CUDA graph, CUDA events, median of 7).
Needs a CUDA device and nvcc; the copies go to build/yasph2d_tpu_torch/.
Prints one JSON line.
"""

import argparse
import ctypes
import json

import numpy as np
import torch

# kernel: (source in csrc/, {variant: (line of the source, the statement
# inserted after it)})
CUTS = {
    "k1": ("pair_reduce.cu", {
        "scan": ("  if (n_live == 0) return;  // uniform across the block: an air tile",
                 "  return;"),
        "staged": ("  // the live queries, one per thread, in slot order", "  return;"),
    }),
    "k5": ("tile_pair_reduce.cu", {
        "scan": ("    __syncthreads();   // the list is complete", "    return;"),
        "staged": ("    // the live queries, one per thread, in slot order", "    return;"),
    }),
}


def build_variant(kernel: str, name: str):
    """Compile the source of `kernel` cut after the phase `name` of CUTS into
    its own library and load it with the kernel's launcher signatures."""
    from yasph2d_tpu_torch.ops import cuda_build

    source, cuts = CUTS[kernel]
    anchor, stmt = cuts[name]
    src = (cuda_build.CSRC / source).read_text()
    if src.count(anchor + "\n") != 1:
        raise RuntimeError(f"k1_phases: anchor of {name!r} not found once in {source}")
    out_dir = cuda_build.BUILD_DIR / "k1_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{kernel}_{name}.cu"
    cu.write_text(src.replace(anchor + "\n", f"{anchor}\n{stmt}\n"))
    lib_path = out_dir / f"lib{kernel}_{name}.so"
    cuda_build._run_all([[cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(cuda_build.CSRC), "-shared", "-o", str(lib_path), str(cu)]])
    lib = ctypes.CDLL(str(lib_path))
    ref = cuda_build.library()
    names = [f"tile_pair_reduce_{f}" for f in cuda_build.TILE_PAIR_FORMS] if kernel == "k5" \
        else [f"pair_reduce_{f}{x}" for f in cuda_build.PAIR_FORMS for x in ("", "_bf16")]
    for fname in names:
        fn, model = getattr(lib, fname), getattr(ref, fname)
        fn.argtypes, fn.restype = model.argtypes, model.restype
    return lib


def main(argv=None):
    from yasph2d_tpu_torch.ops import cuda_build
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.ops import pallas_pair as tpp
    from yasph2d_tpu_torch.ops.sm_pair_reduce import _comps
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools.kernel_times import padded_calls, plane_calls
    from yasph2d_tpu_torch.utils.cuda_timing import graph_ms

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", default="dfsph_plane")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_phases needs a CUDA device")
    device = torch.device("cuda", 0)

    world = double_dam_break(args.particles)
    solver, boundary = bench_solver(args.kind, world, device=device)
    carry = solver.init_carry(world.initial_state(device=device), boundary)
    carry, _ = solver.simulate(carry, boundary, args.steps)
    kernel = "k5" if "padded" in args.kind else "k1"
    if kernel == "k5" and solver.grid.use_pallas_slotmajor:
        raise SystemExit("k1_phases: a padded kind must be on its K5 route (*_k5)")
    c = solver._consts
    runs = {}  # label: function of the launch's tile, and its tile
    if kernel == "k5":
        for label, (form, q, s, kw) in padded_calls(
                solver, boundary, carry, np.random.default_rng(0)).items():
            tile = tpp.tile_shape(q[1].shape[2], s[1].shape[2],
                                  len(_comps(kw.get("s_vals", ()))))
            runs[label] = (lambda form=form, q=q, s=s, kw=kw, tile=tile: tpp.launch(
                form, *q, *s, c, kw.get("q_vals", ()), kw.get("s_vals", ()),
                kw.get("scalars", ()), tile))
        live = int(q[1].sum())
    else:
        for label, (form, q, s, kw) in plane_calls(
                solver, boundary, carry, np.random.default_rng(0)).items():
            tile = pr.tile_shape(q.mask.shape[0], s.mask.shape[0],
                                 len(pr._planes(kw.get("s_vals", ()))),
                                 q.rebase_cell is not None, *q.mask.shape[1:])
            runs[label] = (lambda form=form, q=q, s=s, kw=kw, tile=tile: pr.launch(
                form, q, s, c, kw.get("q_vals", ()), kw.get("s_vals", ()),
                kw.get("scalars", ()), kw.get("post_planes", ()), tile[:3]))
        live = int(q.mask.sum())
    libs = {"full": cuda_build.library(),
            **{n: build_variant(kernel, n) for n in CUTS[kernel][1]}}
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
