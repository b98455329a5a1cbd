"""Native (C++) host components of the renderer, loaded with ctypes (the port of
yasph2d_tpu/native).

`render.cpp` (the rasterizer `yasph_rasterize`, the PNG encoder
`yasph_write_png`) and `recorder.cpp` (the asynchronous PNG recorder
`yasph_recorder_*`) are copies of the JAX package's sources. At first use they
are built with g++ into one shared library in `build/yasph2d_tpu_torch/` at the
repository root (git-ignored), named by a digest of the sources, the flags and
the machine (`-march=native` code runs only where it was built), as
ops/cuda_build.py names the kernel library. Nothing runs at import. A failed
build raises with g++'s output: no caller falls back to NumPy unasked.
"""

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = (_DIR / "render.cpp", _DIR / "recorder.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yasph2d_tpu_torch"
# the JAX package's flags (yasph2d_tpu/native/__init__.py): the same code, so
# the two libraries draw the same pixels on one machine
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    digest.update(f"{platform.machine()} {platform.node()}".encode())
    for src in SOURCES:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"librender_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one for these exact sources exists; raise
    with g++'s output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native renderer needs g++: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native render build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_render() -> ctypes.CDLL:
    """The native render library (built on first call); raises if it cannot
    be built or loaded."""
    lib = ctypes.CDLL(str(build()))
    lib.yasph_rasterize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # positions, velocities, n
        ctypes.c_void_p, ctypes.c_int64,  # boundary, nb
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # image, w, h
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # cam_x, cam_y, scale
        ctypes.c_float,  # radius_px
        ctypes.c_float, ctypes.c_float, ctypes.c_float,  # background rgb
    ]
    lib.yasph_rasterize.restype = None
    lib.yasph_write_png.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32
    ]
    lib.yasph_write_png.restype = ctypes.c_int32
    lib.yasph_recorder_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
    ]
    lib.yasph_recorder_create.restype = ctypes.c_void_p
    lib.yasph_recorder_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
    ]
    lib.yasph_recorder_submit.restype = ctypes.c_int32
    lib.yasph_recorder_flush.argtypes = [ctypes.c_void_p]
    lib.yasph_recorder_flush.restype = ctypes.c_int32
    lib.yasph_recorder_destroy.argtypes = [ctypes.c_void_p]
    lib.yasph_recorder_destroy.restype = ctypes.c_int32
    return lib
