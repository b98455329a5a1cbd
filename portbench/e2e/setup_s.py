"""setup_s: from the first statement of run.py to the window's start:
import, CUDA context, kernels, scene, init_carry, settle and the warm-up
replay."""


def read(r):
    return r.window.setup_s
