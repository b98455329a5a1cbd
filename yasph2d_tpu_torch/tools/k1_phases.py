"""Where K1's time goes, phase by phase, on one GPU (the card's hosts have no
ncu or nsys, and torch.profiler times whole kernels only).

    python -m yasph2d_tpu_torch.tools.k1_phases [--kind dfsph_plane]
        [--particles 100000] [--steps 60]

Builds truncated copies of csrc/pair_reduce.cu, each ending its blocks after
one phase of the kernel, and times them beside the full kernel on the same
operands (the step's K1 calls on a settled double dam-break state, as
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

# variant: (line of csrc/pair_reduce.cu, the statement inserted after it)
CUTS = {
    "scan": ("  if (n_live == 0) return;  // uniform across the block: an air tile",
             "  return;"),
    "staged": ("  // the live queries, one per thread, in slot order", "  return;"),
}


def build_variant(name: str):
    """Compile csrc/pair_reduce.cu cut after the phase of CUTS[name] into its
    own library and load it with K1's launcher signatures."""
    from yasph2d_tpu_torch.ops import cuda_build

    anchor, stmt = CUTS[name]
    src = (cuda_build.CSRC / "pair_reduce.cu").read_text()
    if src.count(anchor + "\n") != 1:
        raise RuntimeError(f"k1_phases: anchor of {name!r} not found once in pair_reduce.cu")
    out_dir = cuda_build.BUILD_DIR / "k1_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"pair_reduce_{name}.cu"
    cu.write_text(src.replace(anchor + "\n", f"{anchor}\n{stmt}\n"))
    lib_path = out_dir / f"libk1_{name}.so"
    cuda_build._run_all([[cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                          str(cuda_build.CSRC), "-shared", "-o", str(lib_path), str(cu)]])
    lib = ctypes.CDLL(str(lib_path))
    ref = cuda_build.library()
    for form in cuda_build.PAIR_FORMS:
        for suffix in ("", "_bf16"):
            fn, model = getattr(lib, f"pair_reduce_{form}{suffix}"), \
                getattr(ref, f"pair_reduce_{form}{suffix}")
            fn.argtypes, fn.restype = model.argtypes, model.restype
    return lib


def main(argv=None):
    from yasph2d_tpu_torch.ops import cuda_build
    from yasph2d_tpu_torch.ops import pair_reduce as pr
    from yasph2d_tpu_torch.scenes import bench_solver, double_dam_break
    from yasph2d_tpu_torch.tools.kernel_times import plane_calls
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
    calls = plane_calls(solver, boundary, carry, np.random.default_rng(0))
    libs = {"full": cuda_build.library(), **{n: build_variant(n) for n in CUTS}}
    c = solver._consts
    rows = {}
    for label, (form, q, s, kw) in calls.items():
        tile = pr.tile_shape(q.mask.shape[0], s.mask.shape[0],
                             len(pr._planes(kw.get("s_vals", ()))), q.rebase_cell is not None,
                             *q.mask.shape[1:])
        row = {}
        for name, lib in libs.items():
            cuda_build.library = lambda lib=lib: lib  # pr.launch looks it up per call
            row[name] = graph_ms(lambda form=form, q=q, s=s, kw=kw: pr.launch(
                form, q, s, c, kw.get("q_vals", ()), kw.get("s_vals", ()),
                kw.get("scalars", ()), kw.get("post_planes", ()), tile[:3]))
        cuda_build.library = lambda: libs["full"]
        rows[label] = row
        print(f"{label:14s} " + " ".join(f"{k} {v:.5f}" for k, v in row.items()), flush=True)
    print(json.dumps({"kind": args.kind, "particles": args.particles, "steps": args.steps,
                      "live": int(q.mask.sum()), "device": torch.cuda.get_device_name(0),
                      "ms": rows}))


if __name__ == "__main__":
    main()
