"""Data parallelism over `torch.distributed` (`bdm_tpu/parallel/mesh.py`).

The JAX package runs one process with a mesh over every device, and XLA
inserts the collectives. Here each rank is a process of its own, started
by `torchrun` (or `spawn_ranks`), with an explicit device: `cuda:LOCAL_RANK`
on the card, or the CPU when the caller asks for it. The backend follows
one rule (`backend_rule`): NCCL when every rank of the host has a card of
its own, gloo when ranks share a card or run on the CPU. Without
`WORLD_SIZE` in the environment nothing here starts a process group, and
every entry point runs as one process.

A data-parallel rank holds contiguous rows of the global batch
(`shard_batch`, the counterpart of `P("dp")` on the leading axis) and
draws its noise as the rows of the global draw (`ShardedNoise`), so P
ranks on B / P rows each take the step one process takes on B rows.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import time
from dataclasses import fields, is_dataclass, replace
from typing import Callable, Optional

import torch
import torch.distributed as dist

from bdm_tpu_torch import resolve_device


def get_world_for_batch(batch_size: int, world: int) -> Optional[int]:
    """The ranks that hold a shard of a batch: the largest divisor of
    `batch_size` that is at most `world`; None when that is 1 (one process
    does the work). The rule of `get_mesh_for_batch`; ranks beyond it get
    no shard."""
    n = min(int(world), int(batch_size))
    while n > 1 and batch_size % n != 0:
        n -= 1
    return None if n <= 1 else n


def backend_rule(device: torch.device, local_world: int) -> tuple:
    """-> (backend, why): NCCL when each of the host's `local_world` ranks
    has a card of its own, gloo when they share a card (NCCL refuses two
    ranks on one GPU) or run on the CPU."""
    if device.type != "cuda":
        return "gloo", "ranks on the CPU"
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", f"{local_world} rank(s) on {cards} card(s), a card each"
    return "gloo", f"{local_world} ranks share {cards} card(s)"


def _rank_device(device, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_distributed(device=None) -> torch.device:
    """Join the process group that `RANK`, `WORLD_SIZE`, `LOCAL_RANK` (and
    `MASTER_ADDR` / `MASTER_PORT`, as `torchrun` sets them) describe, and
    return this rank's device: `cuda:LOCAL_RANK` (modulo the host's cards)
    unless `device` names another; the backend by `backend_rule`, printed.
    Without `WORLD_SIZE` -> `resolve_device(device)` and no group."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return resolve_device(device)
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    dev = _rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend, why = backend_rule(
        dev, int(env.get("LOCAL_WORLD_SIZE", world)))
    if not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world)
        print(f"rank {rank} of {world}: {dev}, backend {backend} ({why})",
              flush=True)
    return dev


def is_main() -> bool:
    """Rank 0, or no process group: the process that writes checkpoints,
    logs and files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def batch_group(batch_size: int):
    """The data-parallel group of a training job -> (group, this rank's
    index in it, its size): every rank calls it. (None, 0, 1) when one
    process does the work (no process group, or `get_world_for_batch`
    gives None); then, like a rank beyond the group, a rank other than 0
    gets index None and takes no part."""
    if not dist.is_initialized():
        return None, 0, 1
    rank = dist.get_rank()
    n = get_world_for_batch(batch_size, dist.get_world_size())
    if n is None:
        return None, (0 if rank == 0 else None), 1
    group = (dist.group.WORLD if n == dist.get_world_size()
             else dist.new_group(list(range(n))))
    return group, (rank if rank < n else None), n


def rows(x, rank: int, n: int):
    """Rows [rank * B / n, (rank + 1) * B / n) of a (B, ...) tensor, list
    or camera (a dataclass of such tensors); anything else as it is."""
    if isinstance(x, (torch.Tensor, list, tuple)):
        b = len(x)
        if b % n:
            raise ValueError(f"a batch of {b} does not split over {n} ranks")
        per = b // n
        return x[rank * per:(rank + 1) * per]
    if is_dataclass(x) and not isinstance(x, type):
        return replace(x, **{f.name: rows(getattr(x, f.name), rank, n)
                             for f in fields(x)})
    return x


def shard_batch(batch: dict, rank: int, n: int) -> dict:
    """This rank's contiguous rows of every entry of a global batch,
    cameras included (`P("dp")` on the leading axis)."""
    return {k: rows(v, rank, n) for k, v in batch.items()}


@torch.no_grad()
def replicate(model: torch.nn.Module, group=None, src: int = 0):
    """Broadcast rank `src`'s parameters and buffers to every rank of
    `group`; -> the model."""
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, src, group=group)
    return model


class ShardedNoise:
    """One data-parallel rank's view of a noise source that every rank
    holds alike (same seed, or the same replay): each draw is made at the
    global batch (the local leading size times `n`) and this rank's rows
    are returned. So the timesteps, the noise, the dropout keep-masks and
    the samplers' draws of P ranks are those of one process on all rows.
    Serves a `TrainNoise` (`draw`, `keep_mask`) and a `NoiseProvider`
    (`initial`, `step`, `fuse`, `mask`)."""

    def __init__(self, inner, rank: int, n: int):
        self.inner, self.rank, self.n = inner, rank, n

    def _glob(self, shape):
        return (shape[0] * self.n,) + tuple(shape[1:])

    def _rows(self, x):
        return rows(x, self.rank, self.n)

    def draw(self, shape, num_timesteps: int):
        t, noise = self.inner.draw(self._glob(shape), num_timesteps)
        return self._rows(t), self._rows(noise)

    def keep_mask(self, shape, p: float):
        return self._rows(self.inner.keep_mask(self._glob(shape), p))

    def initial(self, shape):
        return self._rows(self.inner.initial(self._glob(shape)))

    def step(self, branch: str, i: int, j: int, n_steps: int, shape):
        return self._rows(self.inner.step(branch, i, j, n_steps,
                                          self._glob(shape)))

    def fuse(self, i: int, shape):
        return self._rows(self.inner.fuse(i, self._glob(shape)))

    def mask(self, i: int, shape):
        return self._rows(self.inner.mask(i, self._glob(shape)))


# ------------------------------------------------------------- launching

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, args: tuple = (),
                timeout: float = 600.0) -> None:
    """Run `fn(*args)` in `world` spawned processes on this host, one rank
    each, with the environment `torchrun` would give them (a free
    localhost port): `fn` calls `init_distributed`. Returns when every rank
    has ended; raises when one fails or `timeout` seconds pass, after
    stopping every rank. `fn` and `args` must pickle (a module-level
    function)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank(s) {failed} of {world} failed "
                                   f"(exit codes "
                                   f"{[procs[r].exitcode for r in failed]})")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks ran past {timeout} s")
            time.sleep(0.05)
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks of {world} exited with {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
