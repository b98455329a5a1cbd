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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yasph2d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into on sm_90


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
        "mu_m", "vl_h", "vl_norm",
    )]


# K1's call forms (csrc/pair_reduce.cuh K1_PAIR_FORMS): the DFSPH plane step's
# six, its unfused step's three passes without an epilogue, then the WCSPH
# plane step's three, then the physical viscosity forms of both steps
PAIR_FORMS = ("ctx", "ctx_post", "visc_gravity", "err_ki", "delta_ki", "corr_v",
              "visc", "div", "corr",
              "wcsph_density", "wcsph_stat", "wcsph_forces",
              "visc_gravity_phys", "wcsph_forces_phys", "visc_phys")
# K3's call forms (csrc/tile_pair_reduce.cu, K3's sum order): the WCSPH padded
# step's three, then the DFSPH padded step's five, then the physical viscosity
# forms of both steps
SM_PAIR_FORMS = ("wcsph_density", "wcsph_stat", "wcsph_forces",
                 "dfsph_ctx", "dfsph_stat", "dfsph_div", "dfsph_corr", "dfsph_visc",
                 "dfsph_visc_phys", "wcsph_forces_phys")
# K5's call forms (csrc/tile_pair_reduce.cuh K5_PAIR_FORMS): the DFSPH padded
# step's four, then the WCSPH padded step's three, then the physical viscosity
# forms of both; each also has a bf16 math mode, `<form>_bf16`, and a halo
# form of each mode (csrc/tile_pair_reduce_halo.cu), `<form>[_bf16]_halo`
TILE_PAIR_FORMS = ("dfsph_ctx", "dfsph_div", "dfsph_corr", "dfsph_visc",
                   "wcsph_density", "wcsph_stat", "wcsph_forces",
                   "dfsph_visc_phys", "wcsph_forces_phys")

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for form in PAIR_FORMS:
        # q_pos, q_mask, s_pos, s_mask, planes, n_planes, out, P, Ps, ny, nx,
        # ty, tx, threads, smem, scalar, [cell: bf16 operands only], [h_pos,
        # h_mask, h_planes: halo forms only (csrc/pair_reduce_halo.cu)],
        # consts, stream
        for halo in ((), (_P, _P, ctypes.POINTER(_P))):
            for name, cell in ((form, ()), (f"{form}_bf16", (ctypes.c_float,))):
                fn = getattr(lib, f"pair_reduce_{name}{'_halo' if halo else ''}")
                fn.argtypes = [_P, _P, _P, _P, ctypes.POINTER(_P), _I, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, *cell,
                               *halo, ctypes.POINTER(PairConsts), _P]
                fn.restype = _I
    for name in ([f"sm_pair_reduce_{f}" for f in SM_PAIR_FORMS]
                 + [f"tile_pair_reduce_{f}" for f in TILE_PAIR_FORMS]):
        fn = getattr(lib, name)
        # q_pos, q_mask, s_pos, s_mask, vals, strides, n_vals, out, P, Ps, ny,
        # nx, ty, tx, threads, query round, smem, scalar, gate, gate's
        # iteration, consts, stream
        fn.argtypes = [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P, _I,
                       ctypes.POINTER(PairConsts), _P]
        fn.restype = _I
    for form in TILE_PAIR_FORMS:
        # K5's bf16 mode: the rebase (origin x, origin y, cell size, first
        # global row) after the scalar; the halo forms: the halo rows'
        # positions, mask and source value pointers before the gate
        head = [_P, _P, _P, _P, ctypes.POINTER(_P), ctypes.POINTER(_I), _I, _P,
                _I, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float]
        rebase = [ctypes.c_float, ctypes.c_float, ctypes.c_float, _I]
        halo = [_P, _P, ctypes.POINTER(_P)]
        tail = [_P, _I, ctypes.POINTER(PairConsts), _P]
        for name, args in ((f"{form}_bf16", head + rebase + tail),
                           (f"{form}_halo", head + halo + tail),
                           (f"{form}_bf16_halo", head + rebase + halo + tail)):
            fn = getattr(lib, f"tile_pair_reduce_{name}")
            fn.argtypes = args
            fn.restype = _I
    # mask, payload planes, n_pay, out, new mask, dropped, P, ny, nx,
    # grid nx, grid ny, 1/cell size, origin x, origin y, stream
    lib.rebucket.argtypes = [_P, ctypes.POINTER(_P), _I, _P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.c_float, ctypes.c_float, ctypes.c_float, _P]
    lib.rebucket.restype = _I
    # the halo form: as rebucket with the global row count for grid ny, then
    # halo mask, halo payload planes, row0, stream
    lib.rebucket_halo.argtypes = lib.rebucket.argtypes[:-1] + [_P, ctypes.POINTER(_P), _I, _P]
    lib.rebucket_halo.restype = _I
    # mask, pos, part inputs, part outputs, part widths, n_parts, out_pos, new mask,
    # dropped, P, ny, nx, grid nx, grid ny, 1/cell size, origin x, origin y, stream
    lib.sm_rebucket.argtypes = [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                                ctypes.POINTER(_I), _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                ctypes.c_float, ctypes.c_float, ctypes.c_float, _P]
    lib.sm_rebucket.restype = _I
    # the halo form: as sm_rebucket with the global row count for grid ny, then
    # halo mask, halo positions, halo part inputs, row0, stream
    lib.sm_rebucket_halo.argtypes = lib.sm_rebucket.argtypes[:-1] + [
        _P, _P, ctypes.POINTER(_P), _I, _P]
    lib.sm_rebucket_halo.restype = _I
    # the padded WCSPH step's glue (csrc/slot_glue.cu): mask, the inputs, the
    # outputs, slot count, the float arguments, [dead_zero], stream
    _F = ctypes.c_float
    for name, args in (("slot_kick_drift", [_P] * 6 + [_I, _F, _F]),
                       ("slot_density_tait", [_P] * 5 + [_I, _F, _F, _F, _F, _I]),
                       ("slot_accel_cfl", [_P] * 6 + [_I, _F, _F, _F]),
                       ("slot_kick", [_P] * 4 + [_I, _F])):
        getattr(lib, name).argtypes = args + [_P]
        getattr(lib, name).restype = _I
    # the DFSPH pressure loops' glue (csrc/pressure_glue.cu): mask, the
    # inputs, the in-place outputs, [scratch, total], slot count, the float
    # arguments, [density], dead_zero, the loop's state and the launch's
    # iteration, [the exit test's live count, tolerance and cap], stream;
    # the scratch's block count
    lib.slot_pressure_err.argtypes = [_P] * 10 + [_I, _F, _F, _F, _I, _I, _P, _I, _F, _F, _I,
                                                  _P]
    lib.slot_pressure_err.restype = _I
    lib.slot_pressure_kick.argtypes = [_P] * 5 + [_I, _F, _I, _P, _I, _P]
    lib.slot_pressure_kick.restype = _I
    lib.slot_pressure_blocks.argtypes = [_I]
    lib.slot_pressure_blocks.restype = _I
    for probe in ("vpu_fma_probe", "vpu_mix_probe"):  # K6
        # x, out, n, chains, inner, trips, stream
        getattr(lib, probe).argtypes = [_P, _P, _I, _I, _I, _I, _P]
        getattr(lib, probe).restype = _I
    # K7 (csrc/pair_reduce.cu): q, s, out, P, Ps, ny, nx, ty, tx, threads, smem,
    # consts, stream
    lib.probe_ctx.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(PairConsts), _P]
    lib.probe_ctx.restype = _I
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


def plane_pointers(vals, device, p, ny, nx, what) -> list:
    """Data pointers of each (p, ny, nx) f32 plane of `vals`, whose entries
    are (p, ny, nx) planes or (L, p, ny, nx) stacks (one pointer per plane,
    no copy); raises on any other operand."""
    ptrs = []
    for v in vals:
        lead = 1 if v.ndim == 3 else v.shape[0]
        check_tensor(v, device, (p, ny, nx) if v.ndim == 3 else (lead, p, ny, nx),
                     torch.float32, what)
        step = p * ny * nx * v.element_size()
        ptrs.extend(v.data_ptr() + k * step for k in range(lead))
    return ptrs


def pointer_array(ptrs) -> ctypes.Array:
    return (_P * max(len(ptrs), 1))(*ptrs)


def int_array(values) -> ctypes.Array:
    return (_I * max(len(values), 1))(*values)
