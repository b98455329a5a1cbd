"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
        [--pair-dtype bfloat16]

from the root of a checkout that holds `BENCHMARK.json` and the
`yasph2d_tpu_torch` package, on a machine with a CUDA device. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer
metrics), `device`, with `--trace 1` `breakdown`, and last `checks`, each
compared number beside its limit (also the last lines of standard error).
`--pair-dtype bfloat16` runs the program's own bfloat16 pair math instead
of the configuration's precision: the control of the comparison, never a
cell of the benchmark.

Exit codes: 0 with a result line; 2 without a CUDA device, or with fewer
than the cell asks for; 3 if a JAX module was loaded; 1 on any error.
Caches live in the checkout's `build/`: the kernels' nvcc build (the
program's `ops/cuda_build.py` puts it there), and the Triton, extension and
CUDA JIT caches, set here before torch loads so that a kernel of another
kind, added later, finds its cache at a fixed path too.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pair-dtype", choices=("float32", "bfloat16"), default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for key, sub in CACHES.items():
        os.environ[key] = str(ROOT / "build" / "portbench" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    print(f"torch imported {time.perf_counter() - T0:.3f} s after start", file=sys.stderr)

    from portbench import harness, registry

    chips = registry.cell(ROOT, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0,
                              pair_dtype=args.pair_dtype)
    found = harness.forbidden_loaded()
    if found:
        print(f"portbench: JAX modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
