"""Process-group start-up and mesh helpers (port of
`parallel/distributed.py`).

One rank per device.  `init_distributed` starts `torch.distributed` from
an explicit coordinator (``tcp://host:port``, the world size and this
rank) or, under `torchrun`, from its environment (``env://``, JAX's
TPU-pod auto-detection).  The backend is NCCL when the rank's device is a
card and gloo on the CPU; gloo also all-reduces CUDA tensors, which lets
several ranks share one card (NCCL refuses two ranks on one GPU).

Recipes:

    torchrun --nproc_per_node 4 my_fit.py   # one rank per card
    # my_fit.py: init_distributed(); mesh = global_mesh(cameras_axis=2)

    # CPU, 4 ranks, no card: each process calls
    init_distributed("localhost:29500", 4, rank, device="cpu")
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device
from .mesh import MeshLayout, make_mesh

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _rank_device(device: DeviceLike, process_id: int) -> torch.device:
    """The rank's device: `device`, or the card `LOCAL_RANK` (torchrun)
    or the rank names, modulo the cards of the host."""
    if device is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(device)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     device: DeviceLike = None) -> torch.device:
    """Start this rank's process group; returns the rank's device.

    With `coordinator_address` ("host:port") or ``num_processes > 1``
    the world is given explicitly; else under `torchrun` (``WORLD_SIZE``
    and ``MASTER_ADDR`` set) it comes from the environment; else this is
    a single process and nothing is started.  `backend` defaults to NCCL
    for a CUDA device and gloo for the CPU.  `timeout` bounds every
    collective, so a rank that stops answering fails the others instead
    of hanging them.
    """
    env = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    dev = _rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    explicit = (coordinator_address is not None
                or (num_processes is not None and num_processes > 1))
    if explicit:
        if coordinator_address is None:
            raise ValueError("num_processes > 1 needs a coordinator_address")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes or 1, rank=process_id,
            timeout=timeout)
    elif env:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    return dev


def global_mesh(cameras_axis: int = 1):
    """Mesh over every rank of the world: frames gets the rest."""
    n = dist.get_world_size()
    if n % cameras_axis:
        raise ValueError(f"{n} devices not divisible by cameras axis "
                         f"{cameras_axis}")
    return make_mesh(MeshLayout(frames=n // cameras_axis,
                                cameras=cameras_axis))


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global frame batch this rank should load (one
    rank per device, so a rank is JAX's process)."""
    p = dist.get_rank() if dist.is_initialized() else 0
    n = dist.get_world_size() if dist.is_initialized() else 1
    per = global_batch // n
    return slice(p * per, (p + 1) * per)
