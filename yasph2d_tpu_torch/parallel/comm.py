"""The collectives of spatial sharding over `torch.distributed` (the port's
counterpart of the `lax.ppermute` / `psum` / `pmax` that the JAX package's
shard solvers call inside `shard_map`).

One process per shard; shard r owns cell rows [r * ny, (r + 1) * ny) of the
global grid. `SpaceGroup` is one process's view of the group:

- `halo_rows(tensors, dim)` sends each tensor's last row (along its row
  axis `dim`: -2 for the (..., ny, nx) planes, 0 for the (ny, nx, P, ...)
  slot layout) to the next shard and its first row to the previous one, and
  returns the neighbours' rows (row -1 = the previous shard's last row, row
  ny = the next shard's first row). All tensors of a call travel as one
  packed byte buffer each way, one exchange pair, as the JAX `_pf_halo` and
  `halo2d_multi` send all their operands in one `ppermute` pair. At the ends
  of the mesh the received rows are zero bytes: mask False, zero values,
  dead.
- `shift(up, down)` sends the tensors `up` to the next shard and `down` to
  the previous one and returns what the neighbours sent this shard (the JAX
  `lax.ppermute` pair of `fwd` (i -> i + 1) and `bwd` (i + 1 -> i)
  permutations), one packed exchange pair; the sorted route's migration
  buffers travel so. At the ends of the mesh the received tensors are
  zeros, as `ppermute` fills the shards it does not address.
- `sum(x)` and `max(x)` all-reduce a 0-d tensor; `all_gather(x)` stacks every
  shard's tensor along dim 0 in shard order.

The backend is the caller's choice and never a retry:
- "nccl": one card per process, device to device (`batch_isend_irecv`);
- "gloo": the CPU, or several processes sharing one card. gloo sends CPU
  tensors, so halo rows and scalars of CUDA tensors are staged through host
  tensors here, in the open.
A backend that cannot serve the processes' devices raises.

`spawn(fn, world_size, backend, devices, *args)` runs fn(group, *args) in
`world_size` new processes (start method "spawn", never "fork": a forked
CUDA context is unusable) that meet through a `file://` store in a temporary
directory (no port, no network), and returns each rank's result; an exception
in a rank is raised again in the caller.
"""

import os
import shutil
import tempfile
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, devices: Sequence) -> None:
    """Raise unless `backend` can serve processes on `devices` (one per rank)."""
    devices = [torch.device(d) for d in devices]
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError(f"nccl serves CUDA devices only, got {devices}")
        if len({d.index for d in devices}) != len(devices):
            raise ValueError(f"nccl needs one card per rank, got {devices}; several ranks "
                             "on one card take gloo")


class SpaceGroup:
    """One shard's handle on the spatial process group: its shard index
    `rank`, the shard count `size`, its `device` and the `backend`."""

    def __init__(self, rank: int, size: int, device, backend: str, group=None):
        self.device = torch.device(device)
        check_backend(backend, [self.device])
        self.rank, self.size, self.backend, self.group = rank, size, backend, group
        # gloo sends host tensors: stage the device's through the host
        self._staged = backend == "gloo" and self.device.type != "cpu"

    @classmethod
    def world(cls, device, backend: str) -> "SpaceGroup":
        """The default process group, initialised by the caller."""
        return cls(dist.get_rank(), dist.get_world_size(), device, backend)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._staged else t

    def halo_rows(self, planes: Sequence[torch.Tensor], dim: int = -2
                  ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(below, above): for each tensor, the previous shard's last row and
        the next shard's first row along its row axis `dim` (-2 for
        (..., ny, nx) planes, 0 for (ny, nx, P, ...) slots), each of length 1
        there, in the tensor's dtype on this device; dead (zero) rows at the
        ends of the mesh. One packed exchange pair for all tensors."""
        first = [p.narrow(dim, 0, 1) for p in planes]
        last = [p.narrow(dim, p.shape[dim] - 1, 1) for p in planes]
        return self.shift(last, first)

    def shift(self, up: Sequence[torch.Tensor], down: Sequence[torch.Tensor]
              ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(from_below, from_above): the tensors `up` that the previous shard
        sent and the tensors `down` that the next shard sent, shaped and
        typed as this shard's own, on this device; zeros at the ends of the
        mesh. `up` goes to the next shard, `down` to the previous one, in one
        packed exchange pair. Every shard's tensors must have the same
        shapes."""
        recv_below, recv_above = None, None
        if self.size > 1:
            send_up, send_down = self._wire(_pack(up)), self._wire(_pack(down))
            recv_below, recv_above = torch.empty_like(send_up), torch.empty_like(send_down)
            ops = []
            if self.rank + 1 < self.size:
                ops += [dist.P2POp(dist.isend, send_up, self.rank + 1, self.group),
                        dist.P2POp(dist.irecv, recv_above, self.rank + 1, self.group)]
            else:
                recv_above = None
            if self.rank > 0:
                ops += [dist.P2POp(dist.isend, send_down, self.rank - 1, self.group),
                        dist.P2POp(dist.irecv, recv_below, self.rank - 1, self.group)]
            else:
                recv_below = None
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return _unpack(recv_below, up, self.device), _unpack(recv_above, down, self.device)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        t = self._wire(x.detach().reshape(1)).clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t.reshape(()).to(x.device)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The 0-d tensor `x` summed over the shards, on x's device."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest of the shards' 0-d tensors `x`, on x's device."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's `x` (equal shapes), concatenated along dim 0 in shard
        order, on x's device."""
        if self.size == 1:
            return x
        t = self._wire(x.contiguous())
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts).to(x.device)


def _pack(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """The rows' bytes in one uint8 buffer, each row's start 4-byte aligned."""
    parts = []
    for r in rows:
        b = r.contiguous().reshape(-1).view(torch.uint8)
        parts += [b, b.new_zeros((-b.numel()) % 4)]
    return torch.cat(parts)


def _unpack(buf, like: Sequence[torch.Tensor], device) -> List[torch.Tensor]:
    """The rows packed by `_pack` from tensors shaped and typed as `like`; all
    zero (dead) rows when `buf` is None."""
    if buf is None:
        return [torch.zeros(r.shape, dtype=r.dtype, device=device) for r in like]
    buf = buf.to(device)
    out, o = [], 0
    for r in like:
        n = r.numel() * r.element_size()
        out.append(buf[o:o + n].view(r.dtype).reshape(r.shape))
        o += n + (-n) % 4
    return out


def _rank_main(rank, fn, world_size, backend, devices, workdir, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                            world_size=world_size, rank=rank)
    try:
        result = fn(SpaceGroup.world(device, backend), *args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, backend: str, devices: Sequence, *args) -> list:
    """Run fn(group, *args) on `world_size` new processes, rank r on
    `devices[r]`, over `backend`; returns the ranks' results (anything
    `torch.save` takes) in rank order. `fn` must be importable by name (a
    module-level function)."""
    import torch.multiprocessing as mp

    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    check_backend(backend, devices)
    workdir = tempfile.mkdtemp(prefix="yasph_space_")
    try:
        mp.start_processes(_rank_main, args=(fn, world_size, backend, [str(d) for d in devices],
                                             workdir, args),
                           nprocs=world_size, join=True, start_method="spawn")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
