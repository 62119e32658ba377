"""SDF voxelizers: the CUDA kernels `csrc/sdf_grid.cu` (brute force) and
`csrc/sdf_grid_fast.cu` (two phases with exact culls), with the plain
PyTorch version `ops.sdf.sdf_grid` (port of `ops/sdf.py:sdf_grid_pallas`
and `sdf_grid_pallas_fast`).

`sdf_grid_fast` is what the fits call: CUDA tensors launch the two-phase
kernels (or raise), CPU tensors take the plain version.  Every call
voxelizes a whole batch of meshes, verts (..., V, 3), in one launch per
kernel.  The cull tables of the fast kernels are built here with torch
ops on the device, as JAX builds them with XLA one-offs
(`ops/sdf.py:702-754`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from . import cuda_build
from .sdf import sdf_grid, triangles, voxel_line, voxel_step

# Kernel launches; each wrapper adds one where it launches its kernel.
LAUNCHES: Dict[str, int] = {"sdf_grid": 0, "sdf_cross": 0, "sdf_dist": 0}

TILE = 128      # voxels per block: SDF_THREADS in csrc/sdf_common.cuh
CHUNK = 128     # triangles per chunk: SDF_CHUNK in csrc/sdf_common.cuh
MARGIN = 1e-4   # slack on every cull bound, as in JAX
# Operations per (voxel, triangle) pair, counted in csrc/sdf_common.cuh.
DIST_OPS = 116
CROSS_OPS = 60


def _check_tri(tri: torch.Tensor) -> None:
    if tri.dtype != torch.float32 or tri.dim() != 3 or tri.shape[-1] != 9 \
            or not tri.is_contiguous():
        raise ValueError(f"tri: need contiguous float32 (M, F, 9), got "
                         f"{tri.dtype} {tuple(tri.shape)}")


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Brute force (csrc/sdf_grid.cu).
# ---------------------------------------------------------------------------

def bind_grid(lib: ctypes.CDLL):
    fn = lib.mvsf_sdf_grid
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call_grid(fn, tri: torch.Tensor, grid_size: int, stream) -> torch.Tensor:
    """Check tri (M, F, 9), allocate phi (M, G, G, G) and call `fn`."""
    _check_tri(tri)
    M, F = tri.shape[:2]
    G = grid_size
    phi = torch.empty((M, G, G, G), dtype=torch.float32, device=tri.device)
    cuda_build.check(fn(tri.data_ptr(), M, F, G, voxel_step(G),
                        phi.data_ptr(), stream), "sdf_grid kernel")
    return phi


def sdf_grid_cuda(tri: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Launch `csrc/sdf_grid.cu` on CUDA triangles (M, F, 9)."""
    if tri.device.type != "cuda":
        raise ValueError("sdf_grid_cuda: tri must be a CUDA tensor")
    phi = call_grid(bind_grid(cuda_build.load("sdf_grid")), tri, grid_size,
                    _stream(tri.device))
    LAUNCHES["sdf_grid"] += int(tri.shape[0] > 0)
    return phi


# ---------------------------------------------------------------------------
# Two phases with culls (csrc/sdf_grid_fast.cu).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CullTables:
    """Per-mesh cull tables of the two-phase kernels (M meshes, nc chunks
    of CHUNK y-sorted faces, T tiles of TILE voxels per z slice)."""

    tri: torch.Tensor     # (M, F, 9) faces sorted by centroid y
    ny: torch.Tensor      # (M, T) int32 phase-A chunk prefix per tile
    zmask: torch.Tensor   # (M, G, nc) int32 phase-A chunk mask per slice
    order: torch.Tensor   # (M, G*T, nc + 1) int32 phase-B visit order
    lb2: torch.Tensor     # (M, G*T, nc + 1) float32 sorted bounds, +inf last
    G: int
    T: int
    nc: int


def cull_tables(tri: torch.Tensor, grid_size: int) -> CullTables:
    """The cull tables for triangles (M, F, 9), with torch ops on their
    device.  Every bound carries MARGIN, so the culls are conservative."""
    M, F = tri.shape[:2]
    G = grid_size
    dev = tri.device
    # Sort faces by centroid y, so each chunk's box is a thin y band.
    # torch.argsort is not stable; that is harmless: the minimum and the
    # integer crossing count do not depend on the order of the faces.
    ycen = (tri[..., 1] + tri[..., 4] + tri[..., 7]) / 3.0
    perm = torch.argsort(ycen, dim=1)
    tri = torch.gather(tri, 1, perm[..., None].expand(M, F, 9)).contiguous()
    nc = -(-F // CHUNK)
    # Chunk boxes; the last chunk is padded by repeating its last face.
    pad = torch.arange(nc * CHUNK, device=dev).clamp(max=F - 1)
    tp = tri[:, pad].reshape(M, nc, CHUNK * 3, 3)
    cy0, cy1 = tp[..., 1].amin(-1), tp[..., 1].amax(-1)        # (M, nc)
    cz0, cz1 = tp[..., 2].amin(-1), tp[..., 2].amax(-1)

    line = voxel_line(G, dev)                                  # (G,)
    T = -(-G * G // TILE)
    lane0 = torch.arange(T, device=dev) * TILE
    ty0 = line[lane0 // G]                                     # (T,)
    # The band's top row: a tile may straddle rows (TILE % G != 0).
    ty1 = line[torch.clamp(lane0 + TILE - 1, max=G * G - 1) // G]

    # Phase A: a chunk whose y_min lies above the tile's top row, or
    # whose z_min lies above the slice, cannot meet the ray toward
    # (-1, -1, -1).  ny is the last admitted index + 1 in sorted order.
    can_y = cy0[:, None, :] <= ty1[None, :, None] + MARGIN     # (M, T, nc)
    idx = torch.arange(1, nc + 1, dtype=torch.int32, device=dev)
    ny = torch.where(can_y, idx, 0).amax(dim=-1).to(torch.int32)
    zmask = (cz0[:, None, :] <= line[None, :, None] + MARGIN
             ).to(torch.int32)                                 # (M, G, nc)

    # Phase B: the squared y/z gap of each chunk's box to each tile's
    # band is a lower bound of the squared distance of any of its faces
    # to any voxel of the tile; chunks are visited in that order.
    ygap = torch.clamp_min(torch.maximum(
        cy0[:, None, :] - ty1[None, :, None],
        ty0[None, :, None] - cy1[:, None, :]), 0.0)            # (M, T, nc)
    zgap = torch.clamp_min(torch.maximum(
        cz0[:, None, :] - line[None, :, None],
        line[None, :, None] - cz1[:, None, :]), 0.0)           # (M, G, nc)
    lb2 = (ygap[:, None] ** 2 + zgap[:, :, None] ** 2).reshape(M, G * T, nc)
    order = torch.argsort(lb2, dim=-1)
    lb2 = torch.gather(lb2, -1, order)
    order = torch.cat([order.to(torch.int32),
                       torch.zeros((M, G * T, 1), dtype=torch.int32,
                                   device=dev)], dim=-1).contiguous()
    lb2 = torch.cat([lb2, torch.full((M, G * T, 1), float("inf"),
                                     device=dev)], dim=-1).contiguous()
    return CullTables(tri=tri, ny=ny.contiguous(), zmask=zmask.contiguous(),
                      order=order, lb2=lb2, G=G, T=T, nc=nc)


def bind_fast(lib: ctypes.CDLL):
    """(phase A, phase B) C entry points with their argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    cross = lib.mvsf_sdf_cross
    cross.argtypes = [p] * 3 + [i] * 6 + [ctypes.c_float] + [p] * 3
    cross.restype = ctypes.c_int
    dist = lib.mvsf_sdf_dist
    dist.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float] + [p] * 3
    dist.restype = ctypes.c_int
    return cross, dist


def call_cross(fn, tb: CullTables, stream
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase A: (inside (M, G^3), flags (M, G*T)) int32."""
    M, F = tb.tri.shape[:2]
    G, T = tb.G, tb.T
    i32 = dict(dtype=torch.int32, device=tb.tri.device)
    inside = torch.empty((M, G ** 3), **i32)
    flags = torch.empty((M, G * T), **i32)
    cuda_build.check(fn(tb.tri.data_ptr(), tb.ny.data_ptr(),
                        tb.zmask.data_ptr(), M, F, tb.nc, G, T, CHUNK,
                        voxel_step(G), inside.data_ptr(), flags.data_ptr(),
                        stream), "sdf_cross kernel")
    return inside, flags


def call_dist(fn, tb: CullTables, inside: torch.Tensor, flags: torch.Tensor,
              stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase B: (phi (M, G, G, G) float32, chunks visited (M, G*T))."""
    M, F = tb.tri.shape[:2]
    G, T = tb.G, tb.T
    phi = torch.empty((M, G, G, G), dtype=torch.float32,
                      device=tb.tri.device)
    visits = torch.empty((M, G * T), dtype=torch.int32, device=tb.tri.device)
    cuda_build.check(fn(tb.tri.data_ptr(), flags.data_ptr(),
                        tb.order.data_ptr(), tb.lb2.data_ptr(),
                        inside.data_ptr(), M, F, tb.nc, G, T, CHUNK,
                        voxel_step(G), phi.data_ptr(), visits.data_ptr(),
                        stream), "sdf_dist kernel")
    return phi, visits


def sdf_grid_fast_cuda(tri: torch.Tensor, grid_size: int,
                       with_work: bool = False):
    """Launch `csrc/sdf_grid_fast.cu` on CUDA triangles (M, F, 9).

    Returns phi (M, G, G, G), or with `with_work` also a dict of the
    tables, flags and visit counts (what the bounds are computed from).
    """
    _check_tri(tri)
    if tri.device.type != "cuda":
        raise ValueError("sdf_grid_fast_cuda: tri must be a CUDA tensor")
    cross, dist = bind_fast(cuda_build.load("sdf_grid_fast"))
    stream = _stream(tri.device)
    tb = cull_tables(tri, grid_size)
    inside, flags = call_cross(cross, tb, stream)
    LAUNCHES["sdf_cross"] += int(tri.shape[0] > 0)
    phi, visits = call_dist(dist, tb, inside, flags, stream)
    LAUNCHES["sdf_dist"] += int(tri.shape[0] > 0)
    if with_work:
        return phi, dict(tables=tb, inside=inside, flags=flags,
                         visits=visits)
    return phi


def sdf_grid_fast(verts: torch.Tensor, faces: torch.Tensor,
                  grid_size: int = 32) -> torch.Tensor:
    """phi (..., G, G, G) of the meshes verts (..., V, 3) (normalized to
    [-1, 1]^3) with faces (F, 3): the two-phase kernels for CUDA tensors,
    the plain `sdf_grid` for CPU tensors."""
    if verts.is_cuda:
        lead = verts.shape[:-2]
        tri = triangles(verts.reshape((-1,) + verts.shape[-2:]),
                        faces.to(verts.device))
        phi = sdf_grid_fast_cuda(tri, grid_size)
        return phi.reshape(lead + phi.shape[1:])
    if verts.device.type == "cpu":
        return sdf_grid(verts, faces, grid_size)
    raise ValueError(f"unsupported device {verts.device}")
