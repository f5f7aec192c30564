"""Data-parallel training over processes, one process per card (torchrun),
and the share of extraction's work each rank takes (``share``).

The JAX package shards the [2B] batch axis over a mesh of every local
device in one process (moda_tpu/parallel/mesh.py), and XLA's partitioner
makes the sharded step compute what one device computes on the whole batch
(tests/test_parallel_parity.py). The port keeps those semantics with one
process per card:

- each rank holds a share of the pairs: of every micro-batch of m pairs,
  rank r takes pairs r*m/n ... (r+1)*m/n of both halves of the [2B] axis
  (``pair_index``, ``shard_batch``), so under accu_steps the global
  micro-batch j is the one-process step's micro-batch j;
- each rank renders its own rays; every reduction that crosses rays
  (beta_min, the active-sampling top-k, the loss normalizers, the
  silhouette filters, S3IM, the feat-match transport) reads the global
  tensor, rebuilt row for row in the one-process order by
  ``Shard.gather``; the loss is then the same function of the same values
  on every rank;
- ``Shard.gather``'s backward all-reduces the gradient of the global
  tensor and hands each rank its own rows, so each rank's parameter
  gradient holds n times its rays' share plus the terms every rank
  computes alike; ``Comm.mean_`` all-reduces the gradients as one flat
  buffer and divides by n, which counts every term once;
- draws are made at the global shape from generators seeded alike and
  sliced to the rank's rows, so every rank's generator stays in step and
  the terms every rank computes draw the same values;
- parameters and optimizer state are broadcast from rank 0
  (``Comm.broadcast_``) at the start and after every host-side reload or
  re-initialization, and compared by digest at every epoch's end
  (``Comm.check_same``).

Collectives are built from all_reduce and broadcast alone: gloo carries no
other for CUDA tensors, so two ranks can share one card with gloo (NCCL
refuses two ranks on one device). Nothing here catches a collective's
failure: a rank that loses its peers raises.
"""
from __future__ import annotations

import hashlib
import math
import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from moda_tpu_torch.runtime import Device, resolve_device

ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def world_size() -> int:
    """The process count torchrun sets (1 without it)."""
    return int(os.environ.get("WORLD_SIZE") or 1)


class Comm:
    """The process group of a data-parallel run: this process's rank, the
    world size, the device its tensors live on and the backend."""

    def __init__(self, rank: int, world: int, device: torch.device, backend: str):
        self.rank, self.world, self.device, self.backend = rank, world, device, backend

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        dist.all_reduce(t)
        return t

    def mean_(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The mean over the ranks of a dict of same-dtype tensors, through
        one flat all-reduced buffer."""
        names = list(grads)
        flat = torch.cat([grads[k].reshape(-1) for k in names])
        self.all_reduce_(flat).div_(self.world)
        out, off = {}, 0
        for k in names:
            n = grads[k].numel()
            out[k] = flat[off:off + n].view_as(grads[k])
            off += n
        return out

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0):
        """Overwrite every tensor with rank ``src``'s values, one broadcast
        per dtype. Tensors on another device than the group's are copied
        through it."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for dt, ts in by_dtype.items():
            wdt = torch.int32 if dt == torch.bool else dt
            flat = torch.cat([t.detach().reshape(-1).to(self.device, wdt) for t in ts])
            dist.broadcast(flat, src)
            off = 0
            for t in ts:
                t.copy_(flat[off:off + t.numel()].view(t.shape).to(t.device, dt))
                off += t.numel()

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a host decision whose input only
        rank 0 can see, such as a file it wrote)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=self.device)
        dist.broadcast(t, 0)
        return bool(t.item())

    def check_same(self, tensors: Dict[str, torch.Tensor], what: str) -> str:
        """Raise on every rank unless every rank holds the same bytes in
        ``tensors``; returns the digest."""
        h = hashlib.sha256()
        for k in sorted(tensors):
            h.update(k.encode())
            h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
        mine = int.from_bytes(h.digest()[:8], "little", signed=True)
        ref = torch.tensor([mine], dtype=torch.int64, device=self.device)
        dist.broadcast(ref, 0)
        bad = torch.tensor([int(int(ref.item()) != mine)], dtype=torch.int64, device=self.device)
        self.all_reduce_(bad)
        if int(bad.item()):
            raise RuntimeError(f"{what}: {int(bad.item())} of {self.world} ranks hold other "
                               f"values than rank 0 (this rank's digest {h.hexdigest()[:16]})")
        return h.hexdigest()[:16]

    def close(self):
        dist.destroy_process_group()


def init_process(rank: int, world: int, *, port: int, addr: str = "localhost",
                 local_rank: Optional[int] = None, device: Device = None,
                 backend: Optional[str] = None, timeout_s: float = 1800.0) -> Comm:
    """Join the process group of ``world`` ranks at tcp://addr:port as
    ``rank``. Without ``device`` the rank runs on cuda:local_rank and
    raises when the host has no such card; device="cpu" runs it on the
    CPU (the tests); an explicit CUDA device lets several ranks share one
    card (with backend="gloo"). The backend is NCCL on a card unless named."""
    local_rank = rank if local_rank is None else local_rank
    if device is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= n:
            raise RuntimeError(f"rank {rank}: local rank {local_rank} has no card of its own "
                               f"({n} visible); pass device='cpu' to run on the CPU")
        device = torch.device("cuda", local_rank)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=timeout_s))
    return Comm(rank, world, dev, backend)


def init_from_env(device: Device = None, backend: Optional[str] = None,
                  timeout_s: float = 1800.0) -> Comm:
    """``init_process`` from torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); raises when one is missing."""
    missing = [k for k in ENV if not os.environ.get(k)]
    if missing:
        raise RuntimeError(f"WORLD_SIZE > 1 without torchrun's {missing}: launch with "
                           "torchrun --nproc_per_node N")
    env = {k: os.environ[k] for k in ENV}
    return init_process(int(env["RANK"]), int(env["WORLD_SIZE"]), port=int(env["MASTER_PORT"]),
                        addr=env["MASTER_ADDR"], local_rank=int(env["LOCAL_RANK"]),
                        device=device, backend=backend, timeout_s=timeout_s)


# ------------------------------------------------------------ the layout
def share(n: int, rank: int, world: int) -> range:
    """``rank``'s contiguous share of n units of work split over ``world``
    ranks: units rank*n//world ... (rank+1)*n//world - 1 (extraction's grid
    chunks and frame groups)."""
    return range(rank * n // world, (rank + 1) * n // world)


def pair_index(rank: int, world: int, n_local: int, accu_steps: int = 1) -> np.ndarray:
    """The rows of the global [2B] batch (B = n_local * world pairs) that
    ``rank`` holds, in its local order: of each of the accu_steps
    micro-batches of m = B / accu_steps pairs, pairs r*m/n ... (r+1)*m/n,
    in both halves."""
    if n_local % accu_steps:
        raise ValueError(f"{n_local} pairs a rank do not split into {accu_steps} micro-batches")
    B, mbl = n_local * world, n_local // accu_steps
    first = np.asarray([j * mbl * world + rank * mbl + i for j in range(accu_steps)
                        for i in range(mbl)], np.int64)
    return np.concatenate([first, first + B])


def shard_batch(batch: Dict, rank: int, world: int, accu_steps: int = 1) -> Dict:
    """``rank``'s share of a global batch (numpy arrays or tensors leading
    with [2B]); raises unless B divides into world * accu_steps."""
    B = batch["frameid"].shape[0] // 2
    if B % (world * accu_steps):
        raise ValueError(f"a batch of {B} pairs does not divide into {world} ranks x "
                         f"{accu_steps} micro-batches")
    idx = pair_index(rank, world, B // world, accu_steps)
    return {k: v[torch.as_tensor(idx, device=v.device)] if torch.is_tensor(v) else v[idx]
            for k, v in batch.items()}


class _Gather(torch.autograd.Function):
    """Float tensors' global versions; the backward all-reduces the
    global gradients and takes this rank's rows."""

    @staticmethod
    def forward(ctx, shard, *xs):
        ctx.shard = shard
        # copies: the outputs must not be views of one buffer
        return tuple(y.clone() for y in shard.reduce(xs, scatter=True))

    @staticmethod
    def backward(ctx, *gs):
        shard = ctx.shard
        full = shard.reduce(gs, scatter=False)
        return (None,) + tuple(g[shard.index] for g in full)


class Shard:
    """An axis split over the ranks: this rank holds rows ``index`` (in
    its local order) of a global axis of ``n`` rows."""

    def __init__(self, comm: Comm, index: torch.Tensor, n: int):
        self.comm, self.index, self.n = comm, index, int(n)

    def sub(self, index: torch.Tensor, n: int) -> "Shard":
        return Shard(self.comm, index, n)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global tensor."""
        return x[self.index]

    def reduce(self, xs: Sequence[torch.Tensor], scatter: bool) -> List[torch.Tensor]:
        """All-reduce (sum) of tensors packed into one buffer per dtype.
        scatter=True: each rank's local rows are placed at their global
        rows of a zero buffer first (the global tensor: x + 0 is exact)."""
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault(x.dtype, []).append(i)
        for dt, ids in by_dtype.items():
            wdt = torch.int32 if dt == torch.bool else dt
            cols = [math.prod(xs[i].shape[1:]) for i in ids]
            packed = torch.cat([xs[i].reshape(-1, c).to(wdt) for i, c in zip(ids, cols)], 1)
            if scatter:
                buf = torch.zeros(self.n, packed.shape[1], dtype=wdt, device=packed.device)
                buf[self.index] = packed
            else:
                buf = packed.contiguous()
            self.comm.all_reduce_(buf)
            off = 0
            for i, c in zip(ids, cols):
                out[i] = buf[:, off:off + c].reshape((self.n,) + tuple(xs[i].shape[1:])).to(dt)
                off += c
        return out

    def gather(self, *xs: torch.Tensor):
        """The global tensors (one-process row order) of this rank's rows
        ``xs``: float tensors with gradient (see _Gather), others without."""
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        fl = [i for i, x in enumerate(xs) if x.is_floating_point()]
        other = [i for i in range(len(xs)) if i not in fl]
        if fl:
            for i, y in zip(fl, _Gather.apply(self, *[xs[i] for i in fl])):
                out[i] = y
        if other:
            for i, y in zip(other, self.reduce([xs[i] for i in other], scatter=True)):
                out[i] = y
        return out[0] if len(xs) == 1 else tuple(out)

    def gather_dict(self, d: Dict[str, torch.Tensor], keys: Sequence[str]) -> Dict:
        """``d`` with ``keys`` (those present) replaced by their global
        tensors, in one gather."""
        keys = [k for k in keys if k in d]
        if not keys:
            return dict(d)
        got = self.gather(*[d[k] for k in keys])
        got = (got,) if len(keys) == 1 else got
        return dict(d, **dict(zip(keys, got)))
