"""Compare the SASS of the kernels in two builds of the kernel library.

    python -m yasph2d_tpu_torch.tools.sass_compare OLD.so NEW.so
        [--match 'void pair_reduce_kernel<'] [--rename 'ViscTerm<XsphCoef>=ViscTerm' ...]
        [--sub 'PATTERN=REPLACEMENT' ...] [--show N] [--counts HADD2,HMUL2,...]

Disassembles both libraries with `cuobjdump -sass` (CUDA toolkit; on the card's
host), demangles each kernel's name with `cu++filt`, applies the renames (plain
text) and then the subs (regular expressions, `re.sub`) to the NEW names (a
template argument a later tree added, so that a kernel keeps its key), and
compares each kernel whose name starts with `--match`, instruction
by instruction, addresses and encodings dropped. Prints one line per kernel
(same, differs, or only in one build), with `--show` the first N differing
instruction pairs of each kernel that differs, and a JSON summary; exits 1
when a kernel of OLD differs or is missing in NEW. `--counts` prints instead,
for every matched kernel of both builds, its instruction count and how many
of its instructions start with each given opcode prefix (one JSON line a
kernel).
"""

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\* 0x[0-9a-f]+ \*/")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path("/usr/local/cuda/bin") / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found: the comparison needs the CUDA toolkit")
    return found


def kernels(lib: str, renames=(), subs=()) -> dict:
    """{demangled kernel name: [instruction text]} of a library's SASS."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSTR.search(line)
            if m:
                out[name].append(m.group(1))
    mangled = list(out)
    plain = subprocess.run([_tool("cu++filt")], input="\n".join(mangled), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    result = {}
    for m, d in zip(mangled, plain):
        for old, new in renames:
            d = d.replace(old, new)
        for pattern, repl in subs:
            d = re.sub(pattern, repl, d)
        result[d] = out[m]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="sass_compare")
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--match", default="void pair_reduce_kernel<",
                    help="the start of the demangled names to compare")
    ap.add_argument("--rename", action="append", default=[],
                    help="OLD=NEW text replaced in the new build's kernel names")
    ap.add_argument("--sub", action="append", default=[],
                    help="PATTERN=REPLACEMENT regular expression applied after the renames")
    ap.add_argument("--show", type=int, default=0,
                    help="differing instruction pairs to print per kernel")
    ap.add_argument("--counts", default=None,
                    help="comma-separated opcode prefixes to count in each matched kernel")
    args = ap.parse_args(argv)
    renames = [tuple(r.split("=", 1)) for r in args.rename]
    subs = [tuple(r.split("=", 1)) for r in args.sub]
    old = {k: v for k, v in kernels(args.old).items() if k.startswith(args.match)}
    new = {k: v for k, v in kernels(args.new, renames, subs).items()
           if k.startswith(args.match)}
    if args.counts:
        prefixes = args.counts.split(",")
        for build, found in (("old", old), ("new", new)):
            for name, instrs in sorted(found.items()):
                ops = [next(t for t in i.split() if not t.startswith("@")) for i in instrs]
                print(json.dumps({"build": build, "kernel": name, "instructions": len(ops),
                                  **{p: sum(o.startswith(p) for o in ops) for p in prefixes}}))
        return 0
    same, differs, missing = [], [], []
    for name, instrs in sorted(old.items()):
        if name not in new:
            missing.append(name)
            print(f"only in old: {name}")
        elif new[name] == instrs:
            same.append(name)
            print(f"same ({len(instrs)} instructions): {name}")
        else:
            n_diff = sum(a != b for a, b in zip(instrs, new[name])) + abs(
                len(instrs) - len(new[name]))
            differs.append(name)
            print(f"differs ({n_diff} of {len(instrs)} / {len(new[name])}): {name}")
            pairs = [(a, b) for a, b in zip(instrs, new[name]) if a != b]
            for a, b in pairs[:args.show]:
                print(f"    old: {a}\n    new: {b}")
    added = sorted(set(new) - set(old))
    for name in added:
        print(f"only in new ({len(new[name])} instructions): {name}")
    print(json.dumps({"same": len(same), "differs": len(differs), "only_old": len(missing),
                      "only_new": len(added)}))
    return 1 if differs or missing else 0


if __name__ == "__main__":
    sys.exit(main())
