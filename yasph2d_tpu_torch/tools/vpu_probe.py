"""FP32 and HBM speed probes on the card: the roofline's measured denominators
(PyTorch port of tools/vpu_probe.py).

    python -m yasph2d_tpu_torch.tools.vpu_probe          # rates on the card
    python -m yasph2d_tpu_torch.tools.vpu_probe --sass   # also the probes' SASS

K6 (csrc/vpu_probe.cu): `fma_probe` runs k_ops FMAs per element over the TPU
probe's element count (127 x 8 x 1664) with `chains` independent accumulator
chains (one chain is latency-bound); `mix_probe` runs the compare + select +
add blend of the pair kernels' masked accumulate. `hbm_probe` is plain
PyTorch, as the TPU probe's is plain XLA: k whole-array out-of-place
multiplies of a 436 MB array, 2 k 436 MB moved. Every time is device time from
CUDA events; the rates are operations counted as the TPU probe counts them
(an FMA as 2, the mix step as 3) over that time.

A CUDA tensor launches the kernel, a CPU tensor runs the plain twin in the same
module (`fma_probe_ref`, `mix_probe_ref`); the rates are measured on the card
only.
"""

import argparse
import os
import re
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.dense_grid import f32_scalar
from ..utils.cuda_timing import event_ms

NBR, BR, NXP = 127, 8, 1664  # the TPU probe's plane shape (tools/vpu_probe.py:23)
N_ELEMENTS = NBR * BR * NXP  # 1,690,624
K_OPS, INNER = 4096, 8
HBM_SHAPE = (64, 1024, 1664)  # 436 MB of f32, as the TPU probe's
FMA_CHAINS = (4, 8)
MIX_CHAINS = 8

# kernel launches per probe and chain count ("fma4", "fma8", "mix8"), counted
# where the wrapper launches
LAUNCHES = {**{f"fma{c}": 0 for c in FMA_CHAINS}, f"mix{MIX_CHAINS}": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def probe_input(device, n: int = N_ELEMENTS) -> torch.Tensor:
    """The probes' input: every element 0.999, as the TPU probe's."""
    return torch.full((n,), 0.999, dtype=torch.float32, device=device)


def spread_input(device, n: int = N_ELEMENTS, seed: int = 0) -> torch.Tensor:
    """A check input: seeded uniform in [0.3, 1), so the mix's select takes
    both sides and every element differs (a kernel that drops the select or
    reads the wrong element disagrees with its twin)."""
    x = np.random.default_rng(seed).uniform(0.3, 1.0, n).astype(np.float32)
    return torch.as_tensor(x, device=device)


def trips(chains: int, k_ops: int = K_OPS, inner: int = INNER) -> int:
    """Loop trips of `inner` unrolled steps per chain."""
    return k_ops // (chains * inner)


def fma_ops(n: int, chains: int, k_ops: int = K_OPS) -> int:
    """Operations the TPU probe counts for one fma_probe call (:72)."""
    return n * (k_ops // chains) * chains * 2


def mix_ops(n: int, chains: int = MIX_CHAINS, k_ops: int = K_OPS) -> int:
    """Operations the TPU probe counts for one mix_probe call (:109)."""
    return n * (k_ops // chains) * chains * 3


def _seeded(x: torch.Tensor, chains: int) -> torch.Tensor:
    """(chains, n) accumulators a * f32(1 + 0.001 c): the TPU probe's seed,
    whose double factor is rounded to f32 once."""
    seed = torch.tensor(np.array([1.0 + 0.001 * c for c in range(chains)], np.float32),
                        device=x.device)
    return x[None] * seed[:, None]


def _chain_sum(acc: torch.Tensor) -> torch.Tensor:
    out = acc[0]
    for c in range(1, acc.shape[0]):
        out = out + acc[c]
    return out


def fma_probe_ref(x: torch.Tensor, chains: int, k_ops: int = K_OPS,
                  inner: int = INNER) -> torch.Tensor:
    """Plain twin of the fma probe: every chain steps acc = acc * a + 1e-7
    rounded once, as the kernel's FMA: the float64 product of two f32 is
    exact, so only the float64 add (then the f32 cast) rounds; a double
    rounding differs from the FMA's single one by an ulp, rarely."""
    acc = _seeded(x, chains)
    xd, c = x.to(torch.float64), f32_scalar(1.0e-7)
    for _ in range(trips(chains, k_ops, inner) * inner):
        acc = (acc.to(torch.float64) * xd + c).to(torch.float32)
    return _chain_sum(acc)


def mix_probe_ref(x: torch.Tensor, chains: int = MIX_CHAINS, k_ops: int = K_OPS,
                  inner: int = INNER) -> torch.Tensor:
    """Plain twin of the mix probe: acc = acc + where(a > 0.5, a, 0)."""
    acc = _seeded(x, chains)
    for _ in range(trips(chains, k_ops, inner) * inner):
        acc = acc + torch.where(x > 0.5, x, 0.0)
    return _chain_sum(acc)


def _probe(kind: str, x: torch.Tensor, chains: int, k_ops: int, inner: int):
    ref = {"fma": fma_probe_ref, "mix": mix_probe_ref}[kind]
    if x.device.type == "cpu":
        return ref(x, chains, k_ops, inner)
    if x.device.type != "cuda":
        raise ValueError(f"{kind}_probe: unsupported device {x.device}")
    cuda_build.check_tensor(x, x.device, (x.numel(),), torch.float32, f"{kind}_probe: x")
    out = torch.empty_like(x)
    fn = getattr(cuda_build.library(), f"vpu_{kind}_probe")
    err = fn(x.data_ptr(), out.data_ptr(), x.numel(), chains, inner,
             trips(chains, k_ops, inner), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, f"vpu_{kind}_probe")
    LAUNCHES[f"{kind}{chains}"] += 1  # the kernel takes no other chain count
    return out


def fma_probe(x: torch.Tensor, chains: int, k_ops: int = K_OPS,
              inner: int = INNER) -> torch.Tensor:
    """The chains' sums per element after k_ops FMAs (K6 on CUDA tensors,
    chains 4 or 8, inner 8)."""
    return _probe("fma", x, chains, k_ops, inner)


def mix_probe(x: torch.Tensor, chains: int = MIX_CHAINS, k_ops: int = K_OPS,
              inner: int = INNER) -> torch.Tensor:
    """The chains' sums per element after k_ops compare/select/add steps (K6
    on CUDA tensors, chains 8, inner 8)."""
    return _probe("mix", x, chains, k_ops, inner)


def hbm_probe(device, k: int = 16, repeats: int = 7) -> float:
    """Bytes/s of k whole-array out-of-place multiplies over a 436 MB f32
    array, ping-ponged between two buffers (2 k 436 MB moved per call)."""
    a = torch.ones(HBM_SHAPE, dtype=torch.float32, device=device)
    b = torch.empty_like(a)

    def passes():
        x, y = a, b
        for _ in range(k):
            torch.mul(x, 1.0000001, out=y)
            x, y = y, x

    ms = event_ms(passes, repeats)
    return 2 * k * a.numel() * a.element_size() / (ms * 1e-3)


def measure(device, repeats: int = 20) -> dict:
    """Rates on the card: fma TFLOP/s per chain count, mix Tvecop/s, HBM GB/s,
    and each probe kernel's ms."""
    if torch.device(device).type != "cuda":
        raise SystemExit("vpu_probe measures the card: it needs a CUDA device")
    x = probe_input(device)
    n = x.numel()
    out = {}
    for chains in FMA_CHAINS:
        ms = event_ms(lambda: fma_probe(x, chains), repeats)
        out[f"fma{chains}_ms"] = ms
        out[f"fma{chains}_tflops"] = fma_ops(n, chains) / (ms * 1e-3) / 1e12
    ms = event_ms(lambda: mix_probe(x), repeats)
    out["mix_ms"] = ms
    out["mix_tvecops"] = mix_ops(n) / (ms * 1e-3) / 1e12
    out["hbm_gbs"] = hbm_probe(device) / 1e9
    return out


def sass_opcodes(lib_path=None) -> dict:
    """{kernel name: Counter of SASS opcodes} of the probe kernels in the
    built library, from `cuobjdump -sass` of the CUDA toolkit."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    lib = str(lib_path or cuda_build.build())
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "probe_kernel" in m.group(1) else None
            if name:
                out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            out[name][m.group(1).split(".")[0]] += 1
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--sass", action="store_true",
                        help="print the SASS opcode counts of the probe kernels")
    args = parser.parse_args(argv)
    r = measure(args.device)
    print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}", flush=True)
    for chains in FMA_CHAINS:
        print(f"fma x{chains:>2} chains: {r[f'fma{chains}_tflops']:6.2f} Tflop/s "
              f"({r[f'fma{chains}_ms']:.5f} ms)", flush=True)
    print(f"select-mix x{MIX_CHAINS}:   {r['mix_tvecops']:6.2f} Tvecop/s "
          f"({r['mix_ms']:.5f} ms)", flush=True)
    print(f"HBM stream:      {r['hbm_gbs']:6.0f} GB/s", flush=True)
    if args.sass:
        for name, counts in sass_opcodes().items():
            print(f"SASS {name}: {dict(counts.most_common())}", flush=True)
    return r


if __name__ == "__main__":
    main()
