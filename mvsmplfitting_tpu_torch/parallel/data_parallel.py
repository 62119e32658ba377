"""Data parallelism over a process group: the port of JAX's ``("batch",)``
mesh of the training CLIs (`cli/train_pose.py:149-167`), under which XLA
runs the one-device step on the global batch.

A rank holds a contiguous block of the global batch's rows, as
``P("batch")`` places them (`batch_rows`).  What XLA computes over the
whole batch, the ranks compute over their blocks and add up:

- `global_sum`: a differentiable sum over the ranks.  Its backward sums
  the ranks' gradients, so that a rank whose loss is its share of a
  global loss gets its share of the global loss's gradient, the terms of
  the other ranks included (train-mode BatchNorm statistics, the loss
  normalizers);
- `all_reduce_grads`: the sum of every rank's gradients in one flat
  buffer per dtype, one collective a step;
- `broadcast_state`: rank 0's parameters and buffers to every rank.

Every helper takes the process group, with None meaning one process: then
nothing is communicated and the callers run their one-device code.
`COMM` counts the collectives (calls, bytes, and with ``COMM.timed`` the
host seconds inside them, the device synchronized before and after each)
by kind: "grads", "bn", "loss".
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


class CommStats:
    """Collectives by kind: calls, bytes reduced and, while `timed` is
    set, host seconds (each collective between two device syncs)."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def record(self, kind: str, t: torch.Tensor):
        sync = self.timed and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(t.device)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = (self.bytes.get(kind, 0)
                            + t.numel() * t.element_size())
        if self.timed:
            self.seconds[kind] = (self.seconds.get(kind, 0.0)
                                  + time.perf_counter() - t0)


COMM = CommStats()


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group: Group, kind: str) -> None:
    with COMM.record(kind, t):
        dist.all_reduce(t, group=group)


class _GlobalSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, group, kind)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, ctx.group, ctx.kind)
        return g, None, None


def global_sum(x: torch.Tensor, group: Group,
               kind: str = "loss") -> torch.Tensor:
    """``x`` summed over the ranks of `group` (``x`` itself for None),
    differentiable: the gradient that reaches a rank's ``x`` is the sum of
    every rank's gradient of the sum."""
    if group is None:
        return x
    return _GlobalSum.apply(x, group, kind)


def _buckets(tensors: Sequence[torch.Tensor]):
    """Indices of `tensors` grouped by (dtype, device), in order."""
    out: Dict[tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out.values()


def all_reduce_grads(grads: Sequence[torch.Tensor], group: Group,
                     kind: str = "grads") -> List[torch.Tensor]:
    """Every tensor of `grads` summed over the ranks: one flat buffer and
    one all_reduce per dtype, so every rank gets the same bytes.  New
    tensors; `grads` as they are for None."""
    grads = list(grads)
    if group is None:
        return grads
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for idx in _buckets(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        _all_reduce(flat, group, kind)
        for i, part in zip(idx, flat.split([grads[i].numel()
                                            for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


def _src(group) -> int:
    """The global rank of the group's rank 0."""
    return dist.get_global_rank(group, 0)


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, group: Group) -> None:
    """Rank 0's parameters and buffers to every rank of `group`, in place:
    one broadcast per dtype."""
    if group is None:
        return
    tensors = [t.data for t in model.parameters()] + list(model.buffers())
    for idx in _buckets(tensors):
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.broadcast(flat, src=_src(group), group=group)
        for i, part in zip(idx, flat.split([tensors[i].numel()
                                            for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


def broadcast_object(obj, group: Group):
    """Rank 0's picklable `obj` on every rank (`obj` itself for None)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_src(group), group=group)
    return box[0]


def block_rows(global_batch: int, rank: int, world: int) -> range:
    """Rank `rank`'s contiguous block of a global batch over `world`
    ranks, as ``P("batch")`` places it: rows ``[r B/W, (r+1) B/W)``.  A
    world that does not divide the batch is refused (JAX's CLIs then
    train on one device)."""
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    if global_batch % world:
        raise ValueError(f"the global batch of {global_batch} does not "
                         f"divide over a world of {world} ranks")
    per = global_batch // world
    return range(rank * per, (rank + 1) * per)


def batch_rows(global_batch: int, group: Group) -> slice:
    """This rank's block of a global batch (`block_rows`) as a slice."""
    r = block_rows(global_batch, rank(group), world_size(group))
    return slice(r.start, r.stop)


def init_data_parallel(device=None):
    """This process's (device, group) for data-parallel training.

    Under `torchrun` (``WORLD_SIZE`` > 1) the world starts from its
    environment (`init_distributed`, ``env://``) unless it is already up;
    the rank's device is `device`, where a bare "cuda" (or None) means
    ``cuda:LOCAL_RANK``.  One process (no ``WORLD_SIZE`` or 1) gets
    `device` (default CUDA) and the group None.  A world announced
    without a coordinator raises: it never runs as one process."""
    from ..device import resolve_device
    from .distributed import _rank_device, init_distributed

    if device is not None and torch.device(device) == torch.device("cuda"):
        device = None
    if dist.is_initialized():
        if dist.get_world_size() == 1:
            return resolve_device(device), None
        dev = _rank_device(device, dist.get_rank())
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return dev, dist.group.WORLD
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return resolve_device(device), None
    if "MASTER_ADDR" not in os.environ:
        raise RuntimeError(
            f"WORLD_SIZE={world} without MASTER_ADDR: start the ranks with "
            "torchrun or set the coordinator's address")
    dev = init_distributed(device=device)
    if not dist.is_initialized():
        raise RuntimeError("the process group did not start")
    return dev, dist.group.WORLD
