"""The (frames, cameras) rank grid over `torch.distributed` (port of
`parallel/mesh.py`).

One rank per device.  `make_mesh` lays the initialized world out as a
`DeviceMesh` with JAX's axis names; a rank's coordinate on it says which
block of a frame batch it fits (`frames_slice`) and which views it
holds.  JAX's `frames_sharding` / `replicated` place global arrays for
XLA; here every rank holds plain tensors, takes its own block of the
batch with `frames_slice` and collects the whole batch back with
`gather_frames`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

FRAMES_AXIS = "frames"
CAMERAS_AXIS = "cameras"


@dataclass(frozen=True)
class MeshLayout:
    """How ranks map to the logical (frames, cameras) grid."""

    frames: int
    cameras: int

    @property
    def total(self) -> int:
        return self.frames * self.cameras


def make_mesh(layout: Optional[MeshLayout] = None) -> DeviceMesh:
    """A (frames, cameras) mesh over the initialized world
    (`distributed.init_distributed`).

    Default layout: every rank on the `frames` axis (pure frame
    batching).  The mesh's device type follows the world's backend:
    "cuda" for NCCL, "cpu" for gloo (which also reduces CUDA tensors, so
    several ranks can share one card).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call parallel.init_distributed first")
    world = dist.get_world_size()
    if layout is None:
        layout = MeshLayout(frames=world, cameras=1)
    if layout.total != world:
        raise ValueError(
            f"mesh layout {layout} needs {layout.total} devices, "
            f"got {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (layout.frames, layout.cameras),
                            mesh_dim_names=(FRAMES_AXIS, CAMERAS_AXIS))


def axis_block(mesh: DeviceMesh, axis: str, size: int) -> slice:
    """This rank's block of `size` items split evenly over `axis`;
    raises unless the axis divides `size`."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if size % n:
        raise ValueError(f"{size} items not divisible by the {axis} axis "
                         f"({n})")
    per = size // n
    i = mesh.get_local_rank(axis)
    return slice(i * per, (i + 1) * per)


def frames_slice(mesh: DeviceMesh, batch: int) -> slice:
    """This rank's frames of a `batch`-frame batch (the counterpart of
    JAX's `frames_sharding`)."""
    return axis_block(mesh, FRAMES_AXIS, batch)


def gather_frames(mesh: DeviceMesh, local: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """The whole (batch, ...) tensor from each rank's frames block, on
    every rank: each writes its block into zeros and one all_reduce over
    `frames` sums them (exact, and on any backend: gloo reduces CUDA
    tensors but does not gather them)."""
    out = local.new_zeros((batch,) + tuple(local.shape[1:]))
    out[frames_slice(mesh, batch)] = local
    dist.all_reduce(out, group=mesh.get_group(FRAMES_AXIS))
    return out
