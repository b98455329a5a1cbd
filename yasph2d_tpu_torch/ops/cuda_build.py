"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources have a plain C interface and include no PyTorch header, so `nvcc`
builds them in seconds. At first use each source is compiled for Hopper
(sm_90a) by its own `nvcc` process, all started together, and the objects are
linked into one library in `build/yasph2d_tpu_torch/` at the repository root,
under a name keyed by a hash of the sources and flags, and loaded with ctypes.
Nothing runs at import: the CPU-only test suite imports every module.

Flags: no --use_fast_math (IEEE division and sqrt, as in the JAX package), and
-fmad=false so that no multiply-add is contracted: each kernel then performs
the same float32 operations, in the same order, as its plain PyTorch twin.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yasph2d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libyasph2d_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's output
    once every process has ended."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError(failed[0])


def build() -> Path:
    """Compile the kernels unless a library for these exact sources exists:
    one nvcc per source, in parallel, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    sources = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                  for s, o in zip(sources, objs)])
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, out)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return out


class PairConsts(ctypes.Structure):
    """Float32 constants of the pair kernels (csrc/pair_terms.cuh PairConsts);
    the field order is the C struct's."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "radius_sq", "w_h_inv", "w_norm", "w_norm_grad", "p6_hsq", "p6_norm",
        "xsph_coef", "mass", "w0", "rho0", "alpha_eps", "gx", "gy",
        "d6_hsq", "d6_norm", "sp_h", "sp_norm", "sp_norm_grad", "bff",
    )]


# K1's call forms (csrc/pair_reduce.cu): the DFSPH plane step's six, then the
# WCSPH plane step's three
PAIR_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v",
              "wcsph_density", "wcsph_stat", "wcsph_forces")
# K3's call forms (csrc/sm_pair_reduce.cu): the WCSPH padded step's three,
# then the DFSPH padded step's five
SM_PAIR_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces",
                 "dfsph_ctx", "dfsph_stat", "dfsph_div", "dfsph_corr", "dfsph_visc")
# K5's call forms (csrc/tile_pair_reduce.cu): the DFSPH padded step's four, then
# the WCSPH padded step's three
TILE_PAIR_FORMS = ("dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc",
                   "wcsph_density", "wcsph_stat", "wcsph_forces")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for form in PAIR_FORMS:
        fn = getattr(lib, f"pair_reduce_{form}")
        # q_pos, q_mask, s_pos, s_mask, planes, n_planes, out,
        # P, Ps, ny, nx, scalar, consts, stream
        fn.argtypes = [_P, _P, _P, _P, ctypes.POINTER(_P), _I, _P,
                       _I, _I, _I, _I, ctypes.c_float,
                       ctypes.POINTER(PairConsts), _P]
        fn.restype = _I
    for form in SM_PAIR_FORMS:
        fn = getattr(lib, f"sm_pair_reduce_{form}")
        # q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out,
        # P, Ps, ny, nx, scalar, consts, stream
        fn.argtypes = [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P,
                       _I, _I, _I, _I, ctypes.c_float,
                       ctypes.POINTER(PairConsts), _P]
        fn.restype = _I
    for form in TILE_PAIR_FORMS:
        fn = getattr(lib, f"tile_pair_reduce_{form}")
        # q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out,
        # P, Ps, ny, nx, br, bc, threads, scalar, consts, stream
        fn.argtypes = [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P,
                       _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       ctypes.POINTER(PairConsts), _P]
        fn.restype = _I
    # code, payload planes, n_pay, out, total, P, ny, nx, stream
    lib.rebucket.argtypes = [_P, ctypes.POINTER(_P), _I, _P, _P, _I, _I, _I, _P]
    lib.rebucket.restype = _I
    # code, pos, vals, D, out_pos, out_vals, total, P, ny, nx, stream
    lib.sm_rebucket.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P]
    lib.sm_rebucket.restype = _I
    return lib


def check(err: int, what: str):
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def check_tensor(t, device, shape, dtype, what: str):
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on `device`,
    the only kind of operand a launcher takes."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{what} must be a contiguous {dtype} tensor on {device} of shape "
            f"{tuple(shape)}, got {t.device} {t.dtype} {tuple(t.shape)}"
        )


def pointer_array(ptrs) -> ctypes.Array:
    return (_P * max(len(ptrs), 1))(*ptrs)


def int_array(values) -> ctypes.Array:
    return (_I * max(len(values), 1))(*values)
