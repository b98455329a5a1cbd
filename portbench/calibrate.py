"""Readings of the comparison's numbers over many seeds, in one process,
from which a cell's limits are set (PERF.md gives the readings and the
limits); the benchmark's own runs never run it.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--pair-dtype bfloat16] [--seconds 0.5] [--out FILE]

Each seed is a whole run of the cell (harness.run_cell: set-up, a window of
at least one replay, the check), with `--pair-dtype bfloat16` the control.
One JSON line a seed: the seed, `correct`, the end-to-end metrics and each
compared number; then the largest reading of each number over the seeds
(the lower reading, for the program) and the smallest (the upper reading,
for the control). Needs a CUDA device.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pair-dtype", choices=("float32", "bfloat16"), default=None)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    lines, readings = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        notes = []
        res = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, device,
                               time.perf_counter(), pair_dtype=args.pair_dtype,
                               all_numbers=True, log=notes.append)
        nums = {k: v["value"] for k, v in res["checks"].items()}
        readings.append(nums)
        line = {"seed": seed, "correct": res["correct"], "wall_s": time.perf_counter() - t,
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "numbers": nums, "window": [n for n in notes if n.startswith("window")]}
        lines.append(line)
        print(json.dumps(line), flush=True)
        del res
        torch.cuda.empty_cache()
    keys = sorted(readings[0])
    summary = {"workload": args.workload, "pair_dtype": args.pair_dtype,
               "largest": {k: max(r[k] for r in readings) for k in keys},
               "smallest": {k: min(r[k] for r in readings) for k in keys}}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
