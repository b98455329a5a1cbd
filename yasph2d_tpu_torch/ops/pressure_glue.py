"""The DFSPH pressure loops' glue between the two pair passes of an
iteration, fused into two launches (csrc/pressure_glue.cu), with their plain
PyTorch twins.

An iteration of `DFSPHSlotSolver`'s constant-density and divergence-free
loops (models/dfsph_dense.py) on the slot layout runs K5's (or K3's) div
pass, then

    slot_pressure_err   delta = div + v . sgs; the loop's error of it (the
                        density loop: clamp(rho + (delta m) dt, rho0) - rho0;
                        the divergence loop: clamp(delta m, 0), 0 where the
                        slot has fewer than 9 neighbours); k_i = err alpha;
                        k_sum + k_i; and the sum of err over the live slots,
                        a 0-d tensor that the loop reads back

then the corr pass on k_i, then

    slot_pressure_kick  v - scale (corr + k sgs)

which the density loop's warm start also runs. Each dispatches on the device
of its tensors, as K1-K5 do: a CUDA tensor launches the kernel (counted in
LAUNCHES), a CPU tensor runs the twin (`*_ref`), the loops' torch operations
as they were; `loop_error` is that error on a divergence the caller computed,
in any layout (the plane step and the loop-gradient variants). Every slot a
kernel writes holds the twin's bits: the kernel runs the twin's float32
operations in its order (the library is built with -fmad=false). The sum of
the error is taken in a fixed order of its own, not torch.sum's: the same
bits launch after launch, within float32 rounding of the twin's.

In place, on CUDA: slot_pressure_err updates the loop's k_sum and writes
k_i into the loop's buffer (`loop_work`, +0.0 where it is not written);
slot_pressure_kick updates v. The loops own these tensors (made in the
step), so the step's carry is never written. What a kernel skips, in quads
of four consecutive slots:
- with `dead_zero` (the K5 route, where a dead slot's density is rho0: K5
  writes +0.0 at dead query slots, so the div and corr outputs and sgs are
  +0.0 there), neither kernel loads or writes a quad without a live slot:
  its twin's error there is +0.0, so k_i is +0.0 and v and k_sum stay as
  they are; a quad with a live slot is loaded and written whole, dead slots
  through the twin's operations;
- without it (K3, whose dead query outputs are not zero) every quad is
  loaded and written.

Operands: contiguous float32 slot-major tensors of the mask's (ny, nx, P)
slots and (ny, nx, P, 2) vectors, each 16-byte aligned on CUDA (the kernels
load quads as float4). A wrapper raises on any other device, dtype, shape,
stride or alignment.

The loop's exit test on the device. A loop that the host enqueues ahead of
its test (models/dfsph_dense.py) keeps a state of two int32 words, zero at
its start (`loop_buffers`): the index of its last iteration to run, and the
bits of the last run iteration's average. Its launches come from launchers
(`err_launcher`, `kick_launcher`; K5's and K3's `loop_launcher`), which
check the loop's operands and build the arguments once and return a
function of the iteration i: a launch writes nothing unless i <= state[0].
The error kernel then also runs the host loop's exit test (`exit_test`) on
the total, with an `ExitTest` (the live count, the tolerance, the cap): if
the loop goes on it sets state[0] = i + 1, and it writes the average the
loop reports to state[1] (csrc/pressure_glue.cu), which `read_loop_state`
reads back once for many iterations. On CPU tensors the launchers run the
twins under the same conditions, into the loop's tensors. `ITERATIONS`
counts each loop's iterations enqueued and run (models/dfsph_dense.py
counts them; on the host's test they are equal), `utils/profiling.READBACKS`
the state's read-backs ("loop_state").
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..units import REAL
from ..utils.profiling import read_back
from . import cuda_build
from .dense_grid import f32_scalar
from .slot_glue import _check

f32 = np.float32

# kernel launches, counted where the wrapper launches
LAUNCHES = {"slot_pressure_err": 0, "slot_pressure_kick": 0}
# pressure-loop iterations by loop (density, divergence): enqueued, gated or
# not, and run
ITERATIONS = {f"{loop}_{what}": 0 for loop in ("density", "divergence")
              for what in ("enqueued", "run")}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for name in ITERATIONS:
        ITERATIONS[name] = 0


class ExitTest(NamedTuple):
    """What the error kernel's exit test takes besides the launch's own
    arguments (rho0, dt, the loop)."""

    n_live: float  # the live particle count (float32), the average's divisor
    tol: float  # float32
    max_iterations: int  # the loop runs at most max_iterations + 1 times


def exit_test(mean, rho0, dt, tol, density: bool):
    """(the average a loop reports, whether it goes on) of an iteration's
    mean error, in float32 as the host loops test it (dfsph.rs:226, 381):
    ratio = mean / rho0 goes on while ratio * dt >= tol; the density loop
    reports the mean, the divergence loop the ratio. The cap is the
    caller's."""
    ratio = f32(mean) / f32(rho0)
    return (f32(mean) if density else ratio), bool(ratio * f32(dt) >= f32(tol))


def loop_buffers(work, mask) -> tuple:
    """(k_i (ny, nx, P), the exit test's zero (2,) int32 state) of a loop
    tested on the device: on CUDA views of its `loop_work`, on the CPU
    (`work` None) tensors of their own."""
    if work is None:
        return (torch.zeros(mask.shape, dtype=REAL),
                torch.zeros(2, dtype=torch.int32))
    return work[:mask.numel()].view(mask.shape), work[-2:].view(torch.int32)


def read_loop_state(state) -> tuple:
    """(iterations run, the last one's average as np.float32) of a loop's
    state: one read-back, READBACKS["loop_state"]."""
    last, bits = read_back("loop_state", state)
    return last + 1, np.int32(bits).view(f32)


# ------------------------------------------------------------------- twins


def loop_error(delta, rho_or_count, alpha, k_sum, mask, m: float, dt: float, rho0: float,
               density: bool):
    """A pressure-loop iteration's error of the velocity divergence `delta`
    (dfsph.rs:200-224, 249-280): the density loop's (`density`; `rho_or_count`
    the densities) or the divergence loop's (`rho_or_count` the neighbour
    totals) -> (k_i, k_sum + k_i, the error's 0-d sum over the live slots);
    every slot, any layout."""
    if density:
        err = torch.clamp(rho_or_count + delta * m * dt, min=rho0) - rho0
    else:
        err = torch.clamp(delta * m, min=0.0)
        # particle-deficiency guard (<9 total neighbours, dfsph.rs:260-264)
        err = torch.where(rho_or_count < 9, 0.0, err)
    ki = err * alpha
    return ki, k_sum + ki, torch.where(mask, err, 0.0).sum()


def pressure_err_ref(div, v, sgs, rho_or_count, alpha, k_sum, work, mask, m: float,
                     dt: float, rho0: float, density: bool, dead_zero: bool = False):
    """`loop_error` of delta = div + v . sgs (the slot layout); `work` unused."""
    delta = div + (v[..., 0] * sgs[..., 0] + v[..., 1] * sgs[..., 1])
    return loop_error(delta, rho_or_count, alpha, k_sum, mask, m, dt, rho0, density)


def pressure_kick_ref(v, corr, k, sgs, mask, scale: float, dead_zero: bool = False):
    """v - scale (corr + k sgs) (dfsph.rs:128-161, 200-224); every slot."""
    return v - scale * (corr + k[..., None] * sgs)


# ---------------------------------------------------------------- wrappers


def _check_aligned(what: str, mask, *operands) -> bool:
    """`_check` of slot_glue's wrappers, and on CUDA every operand 16-byte
    aligned. Returns whether it is CUDA."""
    cuda = _check(what, mask, *operands)
    if cuda:
        for t in (mask, *(t for t, _ in operands)):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: expected a 16-byte aligned operand, got "
                                 f"{tuple(t.shape)} at an address {t.data_ptr() % 16} past one")
    return cuda


def _launch(name: str, *args):
    err = getattr(cuda_build.library(), name)(
        *args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, name)
    LAUNCHES[name] += 1


def loop_work(mask):
    """The buffer one pressure loop's slot_pressure_err launches share on
    CUDA: its k_i, (ny, nx, P), then the residual's block partials and
    ticket, then the loop's exit-test state (`loop_buffers`), all zero; None
    on the CPU, where the twins need none."""
    if mask.device.type != "cuda":
        return None
    blocks = cuda_build.library().slot_pressure_blocks(mask.numel())
    if blocks < 0:
        raise ValueError(f"slot_pressure_err: {mask.numel()} slots are too many")
    return torch.zeros(mask.numel() + blocks + 3, dtype=REAL, device=mask.device)


def _err_args(div, v, sgs, rho_or_count, alpha, k_sum, work, ki, mask, m: float, dt: float,
              rho0: float, density: bool, dead_zero: bool) -> tuple:
    """Check `work` (the aligned CUDA operands are checked); (k_i, the 0-d
    total, the launcher's arguments before the loop's state), k_i into `ki`,
    or into `work` where it is None."""
    n = mask.numel()
    if (not isinstance(work, torch.Tensor) or work.device != mask.device
            or work.dtype != REAL or work.numel() != n
            + cuda_build.library().slot_pressure_blocks(n) + 3):
        raise ValueError("slot_pressure_err: `work` must be loop_work(mask)")
    ki = loop_buffers(work, mask)[0] if ki is None else ki
    total = torch.empty((), dtype=REAL, device=mask.device)
    return ki, total, (mask.data_ptr(), div.data_ptr(), v.data_ptr(), sgs.data_ptr(),
                       rho_or_count.data_ptr(), alpha.data_ptr(), ki.data_ptr(),
                       k_sum.data_ptr(), work[n:].data_ptr(), total.data_ptr(), n,
                       f32_scalar(m), f32_scalar(dt), f32_scalar(rho0), int(density),
                       int(dead_zero))


def slot_pressure_err(div, v, sgs, rho_or_count, alpha, k_sum, work, mask, m: float,
                      dt: float, rho0: float, density: bool, dead_zero: bool = False):
    """(k_i, k_sum + k_i, the error's 0-d sum over the live slots) of the div
    pass's (ny, nx, P) sums (module docstring). On CUDA k_sum is updated in
    place and k_i written into `work` (`loop_work(mask)`, kept for the whole
    loop); `dead_zero`: the K5 route's zeros (module docstring)."""
    if not _check_aligned("slot_pressure_err", mask, (div, 1), (v, 2), (sgs, 2),
                          (rho_or_count, 1), (alpha, 1), (k_sum, 1)):
        return pressure_err_ref(div, v, sgs, rho_or_count, alpha, k_sum, work, mask, m, dt,
                                rho0, density, dead_zero)
    ki, total, args = _err_args(div, v, sgs, rho_or_count, alpha, k_sum, work, None, mask, m,
                                dt, rho0, density, dead_zero)
    _launch("slot_pressure_err", *args, None, 0, 0.0, 0.0, 0)
    return ki, k_sum, total


def slot_pressure_kick(v, corr, k, sgs, mask, scale: float, dead_zero: bool = False):
    """v - scale (corr + k sgs) of the corr pass's (ny, nx, P, 2) sums; on
    CUDA v is updated in place and returned."""
    if not _check_aligned("slot_pressure_kick", mask, (v, 2), (corr, 2), (k, 1), (sgs, 2)):
        return pressure_kick_ref(v, corr, k, sgs, mask, scale, dead_zero)
    _launch("slot_pressure_kick", mask.data_ptr(), v.data_ptr(), corr.data_ptr(), k.data_ptr(),
            sgs.data_ptr(), mask.numel(), f32_scalar(scale), int(dead_zero), None, 0)
    return v


def _gated(name: str, state, mask, head: tuple, tail: tuple = (), alive=()) -> Callable:
    """A function of a loop's iteration i that launches `name` with the
    arguments head, the loop's `state`, i, tail on the current stream,
    counted in LAUNCHES; it holds `alive`, the tensors it writes that no
    caller holds."""
    cuda_build.check_tensor(state, mask.device, (2,), torch.int32, f"{name}: loop state")
    fn, stream = getattr(cuda_build.library(), name), torch.cuda.current_stream().cuda_stream
    head += (state.data_ptr(),)

    def launch(i: int, _alive=alive):
        cuda_build.check(fn(*head, i, *tail, stream), name)
        LAUNCHES[name] += 1
    return launch


def err_launcher(div, v, sgs, rho_or_count, alpha, k_sum, work, mask, m: float, dt: float,
                 rho0: float, density: bool, dead_zero: bool, buffers: tuple, test: ExitTest
                 ) -> Callable:
    """slot_pressure_err of a loop's iteration i as a function of i (module
    docstring): k_i into the loop's `buffers` (`loop_buffers(work, mask)`:
    k_i, the state), k_sum in place, gated on the loop's state and testing
    its exit with `test`; on CPU tensors the twin, in place, and
    `exit_test`."""
    ki, state = buffers
    if not _check_aligned("slot_pressure_err", mask, (div, 1), (v, 2), (sgs, 2),
                          (rho_or_count, 1), (alpha, 1), (k_sum, 1), (ki, 1)):
        def launch(i: int):
            if i > int(state[0]):
                return
            out = pressure_err_ref(div, v, sgs, rho_or_count, alpha, k_sum, work, mask, m, dt,
                                   rho0, density)
            ki.copy_(out[0])
            k_sum.copy_(out[1])
            avg, goes_on = exit_test(f32(out[2].item()) / f32(test.n_live), rho0, dt, test.tol,
                                     density)
            if goes_on and i + 1 <= test.max_iterations:
                state[0] = i + 1
            state[1] = int(avg.view(np.int32))
        return launch
    _, total, args = _err_args(div, v, sgs, rho_or_count, alpha, k_sum, work, ki, mask, m, dt,
                               rho0, density, dead_zero)
    return _gated("slot_pressure_err", state, mask, args,
                  (f32_scalar(test.n_live), f32_scalar(test.tol), int(test.max_iterations)),
                  alive=total)


def kick_launcher(v, corr, k, sgs, mask, scale: float, dead_zero: bool, state) -> Callable:
    """slot_pressure_kick of a loop's iteration i as a function of i (module
    docstring): v in place, gated on the loop's `state`; on CPU tensors the
    twin, in place."""
    if not _check_aligned("slot_pressure_kick", mask, (v, 2), (corr, 2), (k, 1), (sgs, 2)):
        def launch(i: int):
            if i <= int(state[0]):
                v.copy_(pressure_kick_ref(v, corr, k, sgs, mask, scale))
        return launch
    return _gated("slot_pressure_kick", state, mask,
                  (mask.data_ptr(), v.data_ptr(), corr.data_ptr(), k.data_ptr(),
                   sgs.data_ptr(), mask.numel(), f32_scalar(scale), int(dead_zero)))
