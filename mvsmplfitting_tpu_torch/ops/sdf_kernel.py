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
import functools
from typing import Dict, Tuple

import torch

from . import cuda_build
from .sdf import sdf_grid, triangles, voxel_line, voxel_step

# Kernel launches; each wrapper adds one where it launches its kernel.
LAUNCHES: Dict[str, int] = {"sdf_grid": 0, "sdf_cross": 0, "sdf_dist": 0}

# The two-phase kernels' shapes (csrc/sdf_grid_fast.cu: B4_*).
BRICK = 8       # voxels per brick edge, one brick per phase-A block
CHUNK = 32      # triangles per chunk
GROUP = 8       # inside voxels per phase-B group (a warp, 4 lanes each)
MAX_CHUNKS = 1024
FAR = 1e4       # coordinate of the padding faces
MARGIN = 1e-4   # slack on every cull bound, as in JAX
# The brute force's shapes (csrc/sdf_grid.cu: B3_*).
GRID_CHUNK = 64     # triangles per chunk
# Operations per (voxel, triangle) pair, counted in csrc/sdf_common.cuh:
# the distance, the crossing, and the crossing's row form (per triangle
# and row of voxels; then per voxel, of which CROSS_COLUMN_OPS depend on
# the triangle and x only; then per pair that passes the pre-test); and
# the compares of phase A's per-face test, per face and row of
# X_PER_THREAD voxels (csrc/sdf_grid_fast.cu).
DIST_OPS = 116
CROSS_OPS = 60
CROSS_ROW_OPS = 14
CROSS_VOXEL_OPS = 37
CROSS_COLUMN_OPS = 5
CROSS_PASS_OPS = 10
FACE_TEST_OPS = 7
X_PER_THREAD = 4


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

@dataclasses.dataclass
class GridTables:
    """The brute force's copies of triangles (M, F, 9), the last of nc
    chunks of GRID_CHUNK padded with far degenerate triangles (no
    crossing; d^2 > 1e6, no new minimum)."""

    tria: torch.Tensor    # (M, nc*GRID_CHUNK, 12) a, b - a, c - a, 0, 0, 0
    trib: torch.Tensor    # (M, nc*GRID_CHUNK, 9) a, b, c
    G: int
    nc: int


def grid_tables(tri: torch.Tensor, grid_size: int) -> GridTables:
    """The tables of `csrc/sdf_grid.cu` for triangles (M, F, 9), with
    torch ops on their device (b - a and c - a are the same single fp32
    subtractions as in `csrc/sdf_common.cuh`)."""
    _check_tri(tri)
    M, F = tri.shape[:2]
    if grid_size ** 3 >= 2 ** 31:
        raise ValueError("sdf_grid: too many voxels for int32 indices")
    nc = max(1, -(-F // GRID_CHUNK))
    far = torch.full((M, nc * GRID_CHUNK - F, 9), FAR, device=tri.device)
    trib = torch.cat([tri, far], dim=1).contiguous()
    a = trib[..., 0:3]
    tria = torch.cat([a, trib[..., 3:6] - a, trib[..., 6:9] - a,
                      torch.zeros_like(a)], dim=-1).contiguous()
    return GridTables(tria=tria, trib=trib, G=grid_size, nc=nc)


def bind_grid(lib: ctypes.CDLL):
    """(pass 1, pass 2) C entry points with their argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    parity = lib.mvsf_sdf_parity
    parity.argtypes = [p] + [i] * 4 + [ctypes.c_float] + [p] * 4
    parity.restype = ctypes.c_int
    dist = lib.mvsf_sdf_inside_dist
    dist.argtypes = [p] * 3 + [i] * 5 + [ctypes.c_float] + [p] * 2
    dist.restype = ctypes.c_int
    return parity, dist


def call_parity(fn, tb: GridTables, stream
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1: (phi (M, G, G, G) with the outside voxels at 0, the work
    lists (M, G^3) int32, mesh m's inside voxels (z G^2 + y G + x) first
    in row m, counts (M + 1,) int64: the length of each list, then the
    (voxel, triangle) pairs that passed the crossing's pre-test)."""
    M = tb.tria.shape[0]
    G = tb.G
    dev = tb.tria.device
    phi = torch.empty((M, G, G, G), dtype=torch.float32, device=dev)
    work = torch.empty((M, G ** 3), dtype=torch.int32, device=dev)
    counts = torch.zeros((M + 1,), dtype=torch.int64, device=dev)
    cuda_build.check(fn(tb.tria.data_ptr(), M, tb.nc, G, GRID_CHUNK,
                        voxel_step(G), phi.data_ptr(), work.data_ptr(),
                        counts.data_ptr(), stream), "sdf_parity kernel")
    return phi, work, counts


def call_inside_dist(fn, tb: GridTables, phi: torch.Tensor,
                     work: torch.Tensor, counts: torch.Tensor, blocks: int,
                     stream) -> None:
    """Pass 2 on `blocks` persistent blocks: fills phi at the listed
    voxels."""
    cuda_build.check(fn(tb.trib.data_ptr(), work.data_ptr(),
                        counts.data_ptr(), tb.trib.shape[0], tb.nc, tb.G,
                        GRID_CHUNK, blocks, voxel_step(tb.G),
                        phi.data_ptr(), stream), "sdf_inside_dist kernel")


def call_grid(fn, tri: torch.Tensor, grid_size: int, stream,
              blocks: int = 0, with_work: bool = False):
    """Both passes of `csrc/sdf_grid.cu` through `fn` = `bind_grid(lib)`
    on triangles (M, F, 9): phi (M, G, G, G), and with `with_work` also
    a dict of the work lists and counts (`call_parity`).  `blocks`: pass
    2's persistent blocks (0: `dist_blocks` of the card)."""
    parity, dist = fn
    tb = grid_tables(tri, grid_size)
    phi, work, counts = call_parity(parity, tb, stream)
    call_inside_dist(dist, tb, phi, work, counts,
                     blocks or dist_blocks(tri.device), stream)
    if with_work:
        return phi, dict(work=work, counts=counts)
    return phi


def sdf_grid_cuda(tri: torch.Tensor, grid_size: int,
                  with_work: bool = False):
    """Launch `csrc/sdf_grid.cu` on CUDA triangles (M, F, 9)."""
    if tri.device.type != "cuda":
        raise ValueError("sdf_grid_cuda: tri must be a CUDA tensor")
    out = call_grid(bind_grid(cuda_build.load("sdf_grid")), tri, grid_size,
                    _stream(tri.device), with_work=with_work)
    LAUNCHES["sdf_grid"] += int(tri.shape[0] > 0)
    return out


# ---------------------------------------------------------------------------
# Two phases with culls (csrc/sdf_grid_fast.cu).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _morton10(device: torch.device) -> torch.Tensor:
    """(1024,) int64: each 10-bit value with its bits spread two zero bits
    apart."""
    q = torch.arange(1024, device=device)
    for shift, bits in ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3),
                        (2, 0x09249249)):
        q = (q | (q << shift)) & bits
    return q


def face_order(tri: torch.Tensor) -> torch.Tensor:
    """(M, F) order of each mesh's faces by a 30-bit Morton key of their
    centroids seen from the corner (-1, -1, -1): the central projection
    (e_x / s, e_y / s) and the depth s = e_x + e_y + e_z, where e = 3 x
    (centroid + 1).  Runs of consecutive faces are then compact both in
    projection (phase A's cone) and in space (phase B's boxes).  Any
    order gives the same result: the minimum and the crossing count do
    not depend on it."""
    e = (tri[..., 0:3] + tri[..., 3:6] + tri[..., 6:9]) + 3.0   # (M, F, 3)
    s = e.sum(-1).clamp_min(1e-6)
    k = torch.stack([e[..., 0] / s, e[..., 1] / s, s], dim=-1)
    lo, hi = k.amin(1, keepdim=True), k.amax(1, keepdim=True)
    q = ((k - lo) / (hi - lo).clamp_min(1e-12) * 1023.0).long().clamp(0, 1023)
    m = _morton10(tri.device)[q]
    return torch.argsort(m[..., 0] | (m[..., 1] << 1) | (m[..., 2] << 2),
                         dim=1)


@functools.lru_cache(maxsize=None)
def brick_boxes(grid_size: int, device: torch.device):
    """Per brick of BRICK^3 voxels (z, then y, then x fastest; the last
    bricks of an axis are cut at the grid's edge): the top corner of the
    box of its voxel centers (NB, 3) as (x, y, z), and the box of its
    central projection from (-1, -1, -1), (NB, 4) as (u_lo, u_hi, v_lo,
    v_hi) with u = e_x / s, v = e_y / s, e = p + 1, s = e_x + e_y + e_z
    (a ratio of linear functions: over a box its extremes lie at the
    corners)."""
    G = grid_size
    line = voxel_line(G, device)
    nb = -(-G // BRICK)
    i0 = torch.arange(nb, device=device) * BRICK
    i1 = torch.clamp(i0 + BRICK - 1, max=G - 1)
    bz, by, bx = torch.meshgrid(*(torch.arange(nb, device=device),) * 3,
                                indexing="ij")
    b = torch.stack([bx, by, bz], dim=-1).reshape(-1, 3)
    lo, hi = line[i0][b], line[i1][b]
    corners = torch.stack(torch.meshgrid(*(torch.arange(2, device=device),)
                                         * 3, indexing="ij"),
                          dim=-1).reshape(8, 3)
    e = torch.where(corners[:, None, :] == 0, lo[None], hi[None]) + 1.0
    s = e.sum(-1)                                            # (8, NB)
    u, v = e[..., 0] / s, e[..., 1] / s
    proj = torch.stack([u.amin(0), u.amax(0), v.amin(0), v.amax(0)], dim=-1)
    return hi, proj


def _projected_boxes(pts: torch.Tensor):
    """Box minimum (..., 3) and projected box (..., 4) as (u_lo, u_hi,
    v_lo, v_hi) of the point sets pts (..., P, 3), the faces' vertices.
    Above -1 on every axis, the projections of the faces they span lie in
    the box of their projections (u = e_x / s, v = e_y / s, e = p + 1,
    s = e_x + e_y + e_z); widened by 2 MARGIN / (s_min - 2 MARGIN) it
    holds the projection of every point within MARGIN of them (|grad u|
    <= sqrt(2) / s).  A set reaching -1 gets an unbounded box."""
    lo = pts.amin(-2)
    e = pts + 1.0
    s = e.sum(-1)
    u, v = e[..., 0] / s, e[..., 1] / s
    above = (lo > -1.0 + 2 * MARGIN).all(-1)
    slack = 2 * MARGIN / torch.clamp_min(s.amin(-1) - 2 * MARGIN, 1e-30)
    inf = torch.full_like(slack, float("inf"))
    box = torch.stack([torch.where(above, u.amin(-1) - slack, -inf),
                       torch.where(above, u.amax(-1) + slack, inf),
                       torch.where(above, v.amin(-1) - slack, -inf),
                       torch.where(above, v.amax(-1) + slack, inf)], -1)
    return lo, box


@dataclasses.dataclass
class CullTables:
    """Per-mesh tables of the two-phase kernels (M meshes, their faces in
    nc chunks of CHUNK, NB = nb^3 bricks of BRICK^3 voxels)."""

    tria: torch.Tensor    # (M, nc*CHUNK, 16) a, b - a, c - a, box min -
                          # MARGIN, projected box (`_projected_boxes`)
    trib: torch.Tensor    # (M, nc*CHUNK, 9) a, b, c, ordered as tria
    boxes: torch.Tensor   # (M, nc, 6) chunk box: min x, y, z, max x, y, z
    mask: torch.Tensor    # (M, NB, nc) bool: the chunks phase A visits
    G: int
    nb: int
    nc: int


def cull_tables(tri: torch.Tensor, grid_size: int) -> CullTables:
    """The tables for triangles (M, F, 9), with torch ops on their
    device.  Every cull carries MARGIN slack, so it is conservative."""
    M, F = tri.shape[:2]
    G = grid_size
    dev = tri.device
    nc = -(-F // CHUNK)
    if nc > MAX_CHUNKS:
        raise ValueError(f"sdf_grid_fast: {F} faces exceed the kernels' "
                         f"{MAX_CHUNKS} chunks of {CHUNK}")
    perm = face_order(tri)
    tri = torch.gather(tri, 1, perm[..., None].expand(M, F, 9))
    # The kernels' copies: the last chunk padded with far degenerate
    # faces (zero area: no crossing; d^2 > 1e6: no new minimum).
    far = torch.full((M, nc * CHUNK - F, 9), FAR, device=dev)
    trib = torch.cat([tri, far], dim=1).contiguous()
    verts = trib.reshape(M, nc * CHUNK, 3, 3)
    fmin, fproj = _projected_boxes(verts)
    # Chunk boxes over the real faces (the last chunk repeats its last);
    # the projected one bounds its faces' widened boxes.
    pad = torch.arange(nc * CHUNK, device=dev).clamp(max=F - 1)
    per_face = torch.cat([fmin, verts.amax(-2), fproj], dim=-1)[:, pad]
    per_face = per_face.reshape(M, nc, CHUNK, 10)
    lo, hi = per_face[..., 0:3].amin(2), per_face[..., 3:6].amax(2)
    cproj = torch.stack([per_face[..., 6].amin(2), per_face[..., 7].amax(2),
                         per_face[..., 8].amin(2), per_face[..., 9].amax(2)],
                        dim=-1)                                # (M, nc, 4)

    # Phase A.  The ray from a voxel toward (-1, -1, -1) with t >= 0
    # stays at or below the voxel on every axis, so a chunk whose box
    # lies above a brick's top on some axis cannot meet any of its rays.
    # Every ray lies on the line through the corner, past it too (t > 1,
    # all coordinates below -1), so a point of that line and its voxel
    # have the same central projection: a brick whose projection misses
    # a chunk's (`_projected_boxes`) has no ray that meets the chunk.
    # The same per face travels with it to the kernel, which skips, per
    # thread, the faces of an admitted chunk that its row cannot meet.
    bhi, bproj = brick_boxes(G, dev)
    mask = ((lo[:, None] <= bhi[None, :, None] + MARGIN).all(-1)
            & (cproj[:, None, :, 0] <= bproj[None, :, None, 1])
            & (bproj[None, :, None, 0] <= cproj[:, None, :, 1])
            & (cproj[:, None, :, 2] <= bproj[None, :, None, 3])
            & (bproj[None, :, None, 2] <= cproj[:, None, :, 3]))
    a = trib[..., 0:3]
    tria = torch.cat([a, trib[..., 3:6] - a, trib[..., 6:9] - a,
                      fmin - MARGIN, fproj], dim=-1).contiguous()
    return CullTables(tria=tria, trib=trib,
                      boxes=torch.cat([lo, hi], -1).contiguous(),
                      mask=mask.contiguous(), G=G, nb=-(-G // BRICK),
                      nc=nc)


def bind_fast(lib: ctypes.CDLL):
    """(phase A, phase B) C entry points with their argument types."""
    p, i = ctypes.c_void_p, ctypes.c_int
    cross = lib.mvsf_sdf_cross
    cross.argtypes = [p] * 2 + [i] * 6 + [ctypes.c_float] + [p] * 4
    cross.restype = ctypes.c_int
    dist = lib.mvsf_sdf_dist
    dist.argtypes = [p] * 4 + [i] * 5 + [ctypes.c_float] + [p] * 3
    dist.restype = ctypes.c_int
    return cross, dist


def call_cross(fn, tb: CullTables, stream
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase A: (phi (M, G, G, G) with the outside voxels at 0, the work
    list of inside voxels (M*NB*BRICK^3,) int32 in groups of GROUP,
    counts (3,) int32: the number of groups, phase B's work counter (0)
    and the (thread, face) pairs phase A evaluated, 4 voxels each)."""
    M = tb.tria.shape[0]
    G, nb = tb.G, tb.nb
    if M * nb ** 3 * BRICK ** 3 >= 2 ** 31:
        raise ValueError("sdf_grid_fast: too many voxels for int32 indices")
    dev = tb.tria.device
    phi = torch.empty((M, G, G, G), dtype=torch.float32, device=dev)
    work = torch.empty((M * nb ** 3 * BRICK ** 3,), dtype=torch.int32,
                       device=dev)
    counts = torch.zeros((3,), dtype=torch.int32, device=dev)
    cuda_build.check(fn(tb.tria.data_ptr(), tb.mask.data_ptr(), M, tb.nc,
                        G, nb, CHUNK, BRICK, voxel_step(G), phi.data_ptr(),
                        work.data_ptr(), counts.data_ptr(), stream),
                     "sdf_cross kernel")
    return phi, work, counts


def call_dist(fn, tb: CullTables, phi: torch.Tensor, work: torch.Tensor,
              counts: torch.Tensor, blocks: int, stream) -> torch.Tensor:
    """Phase B on `blocks` persistent blocks: fills phi at the listed
    voxels; returns the chunks each group visited, (M*NB*BRICK^3 /
    GROUP,) int32, valid up to the group count.  Uses counts[1] as its
    work counter, so run it once per `call_cross`."""
    M = tb.trib.shape[0]
    visits = torch.empty((work.shape[0] // GROUP,), dtype=torch.int32,
                         device=tb.trib.device)
    cuda_build.check(fn(tb.trib.data_ptr(), tb.boxes.data_ptr(),
                        work.data_ptr(), counts.data_ptr(), M, tb.nc, tb.G,
                        CHUNK, blocks, voxel_step(tb.G), phi.data_ptr(),
                        visits.data_ptr(), stream), "sdf_dist kernel")
    return visits


def dist_blocks(device: torch.device) -> int:
    """Persistent blocks of phase B: 8 per SM (32 warps)."""
    return 8 * torch.cuda.get_device_properties(device).multi_processor_count


def sdf_grid_fast_cuda(tri: torch.Tensor, grid_size: int,
                       with_work: bool = False):
    """Launch `csrc/sdf_grid_fast.cu` on CUDA triangles (M, F, 9).

    Returns phi (M, G, G, G), or with `with_work` also a dict of the
    tables, the work list, the counts and the visit counts (what the
    bounds are computed from).
    """
    _check_tri(tri)
    if tri.device.type != "cuda":
        raise ValueError("sdf_grid_fast_cuda: tri must be a CUDA tensor")
    cross, dist = bind_fast(cuda_build.load("sdf_grid_fast"))
    stream = _stream(tri.device)
    tb = cull_tables(tri, grid_size)
    phi, work, counts = call_cross(cross, tb, stream)
    LAUNCHES["sdf_cross"] += int(tri.shape[0] > 0)
    visits = call_dist(dist, tb, phi, work, counts, dist_blocks(tri.device),
                       stream)
    LAUNCHES["sdf_dist"] += int(tri.shape[0] > 0)
    if with_work:
        return phi, dict(tables=tb, work=work, counts=counts, visits=visits)
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
