"""Voxelized inside-distance field and the interpenetration energy (port
of `ops/sdf.py`, grid engine).

The field follows the reference's CUDA voxelizer
(`sdf/sdf/csrc/sdf_cuda_kernel.cu:242-304`): on a G^3 grid over
[-1, 1]^3 with voxel centers at ``-1 + (i + 0.5) * 2/(G-1)`` (x
fastest), phi is 0 outside the mesh and the exact point-triangle
distance to the surface inside, where inside is the parity of
Moller-Trumbore crossings of the ray from the voxel center toward the
corner (-1, -1, -1).

`sdf_grid` is the plain PyTorch version of all three voxelizer kernels
(`ops/sdf_kernel.py`).  Its per-pair arithmetic is written component by
component in the order of `csrc/sdf_common.cuh`, which both CUDA
sources share and which is compiled without FMA contraction, so the
kernels and this function run the same IEEE operations.

The collision sums mirror `code/utils/fitting.py:352-394`: every
person's mesh is voxelized in its own 1.2x-padded box frame, every
person's vertices (their own included) are sampled trilinearly in every
person's grid, and phi carries no derivative; the live box frame does.
Voxelizing launches a CUDA kernel for CUDA tensors, so callers voxelize
on plain tensors and only the sampling runs inside `torch.func`
transforms (see `fitting/stages.py`).

The points engine (`sdf_at_points`, `collision_sums_points`) evaluates
the same field exactly at the query points, with the same pair
arithmetic, in plain PyTorch: JAX has no Pallas kernel there either.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# Running-minimum init: sqrt(1e6) == 1000, the reference's init distance.
FAR_D2 = 1e6
DET_EPS = 1e-7
DIV_FLOOR = 1e-30
# Faces per step of the plain voxelizer's loops.
FACE_CHUNK = 4096


# ---------------------------------------------------------------------------
# Geometry primitives, component by component.
# ---------------------------------------------------------------------------

def _dot3(ux, uy, uz, vx, vy, vz):
    return ux * vx + uy * vy + uz * vz


def _safe_div(a, b):
    return a / torch.where(torch.abs(b) > DIV_FLOOR, b, DIV_FLOOR)


def _closest_vw(ax, ay, az, bx, by, bz, cx, cy, cz, px, py, pz):
    """Ericson closest-point classification: the barycentric (v, w) of
    the closest point a + v ab + w ac, by the where-cascade of
    `point_triangle_closest` (interior, then edges, then vertices)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = _dot3(abx, aby, abz, apx, apy, apz)
    d2 = _dot3(acx, acy, acz, apx, apy, apz)
    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = _dot3(abx, aby, abz, bpx, bpy, bpz)
    d4 = _dot3(acx, acy, acz, bpx, bpy, bpz)
    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = _dot3(abx, aby, abz, cpx, cpy, cpz)
    d6 = _dot3(acx, acy, acz, cpx, cpy, cpz)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    v_ab = torch.clamp(_safe_div(d1, d1 - d3), 0.0, 1.0)
    w_ac = torch.clamp(_safe_div(d2, d2 - d6), 0.0, 1.0)
    w_bc = torch.clamp(_safe_div(d4 - d3, (d4 - d3) + (d5 - d6)), 0.0, 1.0)
    denom = va + vb + vc
    v = _safe_div(vb, denom)
    w = _safe_div(vc, denom)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0)

    v = torch.where(on_bc, 1.0 - w_bc, v)
    w = torch.where(on_bc, w_bc, w)
    v = torch.where(on_ac, 0.0, v)
    w = torch.where(on_ac, w_ac, w)
    v = torch.where(on_ab, v_ab, v)
    w = torch.where(on_ab, 0.0, w)
    v = torch.where(in_c, 0.0, v)
    w = torch.where(in_c, 1.0, w)
    v = torch.where(in_b, 1.0, v)
    w = torch.where(in_b, 0.0, w)
    v = torch.where(in_a, 0.0, v)
    w = torch.where(in_a, 0.0, w)
    return v, w, (abx, aby, abz), (acx, acy, acz)


def _pair_dist_sq(ax, ay, az, bx, by, bz, cx, cy, cz, px, py, pz):
    """Squared point-triangle distance (`sdf_pair_dist_sq` in
    `csrc/sdf_common.cuh`), broadcast over all arguments."""
    v, w, (abx, aby, abz), (acx, acy, acz) = _closest_vw(
        ax, ay, az, bx, by, bz, cx, cy, cz, px, py, pz)
    qx = ax + v * abx + w * acx - px
    qy = ay + v * aby + w * acy - py
    qz = az + v * abz + w * acz - pz
    return qx * qx + qy * qy + qz * qz


def _pair_crossing(ax, ay, az, bx, by, bz, cx, cy, cz, px, py, pz,
                   dxr, dyr, dzr):
    """1 where the ray from p along (dxr, dyr, dzr) crosses the triangle
    (`sdf_pair_crossing` in `csrc/sdf_common.cuh`): Moller-Trumbore with
    |det| > 1e-7, u, v in [0, 1], u + v <= 1, t >= 0."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    pvx = dyr * acz - dzr * acy
    pvy = dzr * acx - dxr * acz
    pvz = dxr * acy - dyr * acx
    det = _dot3(abx, aby, abz, pvx, pvy, pvz)
    ok = torch.abs(det) > DET_EPS
    inv = 1.0 / torch.where(ok, det, 1.0)
    tvx, tvy, tvz = px - ax, py - ay, pz - az
    u = _dot3(tvx, tvy, tvz, pvx, pvy, pvz) * inv
    qvx = tvy * abz - tvz * aby
    qvy = tvz * abx - tvx * abz
    qvz = tvx * aby - tvy * abx
    vv = _dot3(dxr, dyr, dzr, qvx, qvy, qvz) * inv
    tt = _dot3(acx, acy, acz, qvx, qvy, qvz) * inv
    hit = (ok & (u >= 0) & (u <= 1) & (vv >= 0) & (u + vv <= 1)
           & (tt >= 0))
    return hit.to(torch.int32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, as the kernels' `sqrtf`.  PyTorch's
    float32 sqrt on the CPU (its AVX-512 path) is off by one ulp on ~0.7%
    of inputs; the float64 root rounded to float32 is exact."""
    return torch.sqrt(x.double()).float()


def _xyz(t: torch.Tensor):
    return t[..., 0], t[..., 1], t[..., 2]


def point_triangle_closest(p: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closest points on triangles and squared distances, broadcast.

    p, a, b, c: (..., 3).  Returns (closest (..., 3), d^2 (...)).
    """
    ax, ay, az = _xyz(a)
    bx, by, bz = _xyz(b)
    cx, cy, cz = _xyz(c)
    px, py, pz = _xyz(p)
    v, w, ab, ac = _closest_vw(ax, ay, az, bx, by, bz, cx, cy, cz,
                               px, py, pz)
    closest = torch.stack([ax + v * ab[0] + w * ac[0],
                           ay + v * ab[1] + w * ac[1],
                           az + v * ab[2] + w * ac[2]], dim=-1)
    return closest, _pair_dist_sq(ax, ay, az, bx, by, bz, cx, cy, cz,
                                  px, py, pz)


def point_triangle_dist_sq(p: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distance from points to triangles (see
    `point_triangle_closest`)."""
    return point_triangle_closest(p, a, b, c)[1]


def ray_crossings_dir(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """int32 1 where the ray from p along direction d crosses abc."""
    return _pair_crossing(*_xyz(a), *_xyz(b), *_xyz(c), *_xyz(p), *_xyz(d))


def ray_crossings(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Crossing test for the ray p -> (through dest), see above."""
    return ray_crossings_dir(p, a, b, c, dest - p)


def voxel_step(grid_size: int) -> float:
    """2 / (G - 1) rounded once to float32, as JAX rounds the Python
    float when it meets a float32 array; the kernels take this value."""
    return float(np.float32(2.0 / (grid_size - 1)))


def voxel_line(grid_size: int, device=None) -> torch.Tensor:
    """(G,) voxel-center coordinates -1 + (i + 0.5) * dx (float32)."""
    i = torch.arange(grid_size, dtype=torch.float32, device=device)
    return -1.0 + (i + 0.5) * voxel_step(grid_size)


def voxel_centers(grid_size: int, device=None) -> torch.Tensor:
    """(G^3, 3) voxel centers, x fastest (the reference's order)."""
    line = voxel_line(grid_size, device)
    zz, yy, xx = torch.meshgrid(line, line, line, indexing="ij")
    return torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)


# ---------------------------------------------------------------------------
# The plain voxelizer.
# ---------------------------------------------------------------------------

def triangles(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(..., V, 3) vertices -> (..., F, 9) float32 triangles [a, b, c]."""
    tri = verts[..., faces.long(), :]                  # (..., F, 3, 3)
    return tri.reshape(tri.shape[:-2] + (9,)).float().contiguous()


def _pair_budget(t: torch.Tensor, cpu: int = 1 << 20) -> int:
    """(point, face) pairs per step: 2^24 on a GPU, `cpu` on the CPU,
    where smaller temporaries stay in cache."""
    return 1 << 24 if t.is_cuda else cpu


def sdf_grid(verts: torch.Tensor, faces: torch.Tensor,
             grid_size: int = 32) -> torch.Tensor:
    """phi (..., G, G, G) indexed [z, y, x]: the plain PyTorch voxelizer.

    verts: (..., V, 3) normalized to [-1, 1]^3; faces: (F, 3).  Brute
    force over all faces, in two passes: the crossing count of every
    voxel, then the running minimum of d^2 (initialised to 1e6) over all
    faces for the inside voxels only, since phi is 0 at every other voxel
    whatever its distance.  Faces stream in chunks of FACE_CHUNK and
    voxels in chunks too, so no temporary exceeds the pair budget (2^24
    elements on a GPU, 2^20 on the CPU, where smaller temporaries stay
    in cache).
    """
    G = grid_size
    lead = verts.shape[:-2]
    tri = triangles(verts.reshape((-1,) + verts.shape[-2:]), faces)
    centers = voxel_centers(G, tri.device)
    vchunk = max(1, _pair_budget(tri) // FACE_CHUNK)
    out = torch.zeros((tri.shape[0], centers.shape[0]), dtype=torch.float32,
                      device=tri.device)

    def face_chunks(t):
        for f0 in range(0, t.shape[0], FACE_CHUNK):
            c = t[f0:f0 + FACE_CHUNK]
            yield [c[:, i][None] for i in range(9)]           # (1, C) each

    for m in range(tri.shape[0]):
        n_cross = []
        for n0 in range(0, centers.shape[0], vchunk):
            px, py, pz = (centers[n0:n0 + vchunk, i:i + 1] for i in range(3))
            dxr, dyr, dzr = -1.0 - px, -1.0 - py, -1.0 - pz
            count = torch.zeros((px.shape[0],), dtype=torch.int32,
                                device=tri.device)
            for comps in face_chunks(tri[m]):
                count += _pair_crossing(*comps, px, py, pz, dxr, dyr,
                                        dzr).sum(dim=1, dtype=torch.int32)
            n_cross.append(count)
        inside = torch.nonzero(torch.cat(n_cross) % 2 == 1).flatten()
        for n0 in range(0, inside.shape[0], vchunk):
            idx = inside[n0:n0 + vchunk]
            px, py, pz = (centers[idx, i:i + 1] for i in range(3))
            run_min = torch.full((idx.shape[0],), FAR_D2,
                                 dtype=torch.float32, device=tri.device)
            for comps in face_chunks(tri[m]):
                run_min = torch.minimum(
                    run_min, _pair_dist_sq(*comps, px, py, pz).amin(dim=1))
            out[m, idx] = _sqrt(run_min)
    return out.reshape(lead + (G, G, G))


# ---------------------------------------------------------------------------
# Gridless point evaluation (the G -> infinity limit of the field).
# ---------------------------------------------------------------------------

# Faces per chunk of the point field, padded with triangles at 1e6.
POINT_FACE_CHUNK = 512
# Evaluations of the point field (`_sdf_at_points_impl` calls).
FIELD_EVALS = 0


def _face_chunks(verts: torch.Tensor, faces: torch.Tensor,
                 face_chunk: int = POINT_FACE_CHUNK) -> torch.Tensor:
    """(V, 3) vertices -> (F/C, C, 9) float32 triangle chunks, the last
    one padded with degenerate triangles at 1e6 (no crossing, never the
    nearest)."""
    tri = triangles(verts, faces)                      # (F, 9)
    pad = (-tri.shape[0]) % face_chunk
    if pad:
        tri = torch.cat([tri, tri.new_full((pad, 9), 1e6)])
    return tri.reshape(-1, face_chunk, 9)


def _steps(points: torch.Tensor, chunks: torch.Tensor):
    """Yield (point slice, triangles (k*C, 9)) steps of at most the pair
    budget: points in blocks of budget / C, and within a block as many
    whole chunks as the budget allows."""
    nc, C = chunks.shape[:2]
    budget = _pair_budget(points, cpu=1 << 18)    # the fastest on the CPU
    q = max(1, budget // C)
    for n0 in range(0, points.shape[0], q):
        block = slice(n0, min(n0 + q, points.shape[0]))
        k = max(1, budget // (C * (block.stop - n0)))
        for c0 in range(0, nc, k):
            yield block, chunks[c0:c0 + k].reshape(-1, 9)


def _comps(tri: torch.Tensor):
    """(T, 9) triangles -> nine (1, T) coordinate rows."""
    return [tri[:, i][None] for i in range(9)]


def _parity_scan(points: torch.Tensor, chunks: torch.Tensor) -> torch.Tensor:
    """(N,) int32 crossing counts of the rays from points toward the
    corner (-1, -1, -1) over all faces."""
    count = torch.zeros((points.shape[0],), dtype=torch.int32,
                        device=points.device)
    for block, tri in _steps(points, chunks):
        px, py, pz = (points[block, i:i + 1] for i in range(3))
        count[block] += _pair_crossing(*_comps(tri), px, py, pz, -1.0 - px,
                                       -1.0 - py, -1.0 - pz).sum(
                                           dim=1, dtype=torch.int32)
    return count


def _dist_closest_scan(points: torch.Tensor, chunks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(min d^2 (N,), closest surface point (N, 3)): the running minimum
    from 1e6 and closest from zeros; each step takes its first minimum
    face, recomputes the closest point on that face alone, and updates
    where its minimum is strictly lower.  A step spans whole 512-face
    chunks, and the first minimum over a step equals the per-chunk first
    minima merged by strict <, so the result is JAX's chunk scan's."""
    N = points.shape[0]
    min_d2 = torch.full((N,), FAR_D2, dtype=torch.float32,
                        device=points.device)
    closest = torch.zeros((N, 3), dtype=torch.float32, device=points.device)
    for block, tri in _steps(points, chunks):
        p = points[block]
        d2 = _pair_dist_sq(*_comps(tri), p[:, 0:1], p[:, 1:2], p[:, 2:3])
        j = torch.argmin(d2, dim=1)
        step_min = d2.amin(dim=1)
        best = tri[j]                                      # (n, 9)
        cl, _ = point_triangle_closest(p, best[:, 0:3], best[:, 3:6],
                                       best[:, 6:9])
        upd = step_min < min_d2[block]
        min_d2[block] = torch.where(upd, step_min, min_d2[block])
        closest[block] = torch.where(upd[:, None], cl, closest[block])
    return min_d2, closest


def _sdf_at_points_impl(points: torch.Tensor, verts: torch.Tensor,
                        faces: torch.Tensor, _full: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phi (N,), closest (N, 3), inside (N,)) at query points (N, 3) for
    one mesh verts (V, 3), faces (F, 3): the field of `sdf_grid` at
    arbitrary points (distance inside, 0 outside, parity of the ray
    toward (-1, -1, -1)).

    Two culls, as JAX's tiers (`ops/sdf.py:318-380`) but compacted by
    `nonzero`: the parity runs only on the points inside the mesh's box
    (grown by 1e-6; a point outside it is outside the mesh), and the
    distance only on the inside points.  Outside points get phi = 0 and
    closest = 0.  Each point's arithmetic does not depend on which other
    points are evaluated, so on the box's points the culled result
    equals the full one bitwise; `_full` evaluates every point in both
    passes (the tests' yardstick).  Outside the box the full evaluation
    can count an odd number of crossings where a ray grazes an edge
    (as the voxelizers can); the cull gives those points 0, as JAX's
    does.  Plain tensors only: call it outside `torch.func` transforms
    or on unbatched primals.
    """
    global FIELD_EVALS
    FIELD_EVALS += 1
    N = points.shape[0]
    chunks = _face_chunks(verts, faces)
    if _full:
        cand = torch.arange(N, device=points.device)
    else:
        bmin = verts.amin(dim=0) - 1e-6
        bmax = verts.amax(dim=0) + 1e-6
        cand = torch.nonzero(((points >= bmin) & (points <= bmax)).all(-1)
                             ).flatten()
    n_cross = torch.zeros((N,), dtype=torch.int32, device=points.device)
    n_cross[cand] = _parity_scan(points[cand], chunks)
    inside = n_cross % 2 == 1
    idx = cand if _full else torch.nonzero(inside).flatten()
    d2, cl = _dist_closest_scan(points[idx], chunks)
    live = inside[idx]
    phi = torch.zeros((N,), dtype=torch.float32, device=points.device)
    closest = torch.zeros((N, 3), dtype=torch.float32, device=points.device)
    phi[idx] = torch.where(live, _sqrt(d2), 0.0)
    closest[idx] = torch.where(live[:, None], cl, 0.0)
    return phi, closest, inside


class _SdfAtPoints(torch.autograd.Function):
    """phi at points with the analytic spatial derivative (JAX's custom
    JVP, `ops/sdf.py:383-415`).  The second output, g, is the direction
    (p - closest) / phi where the point is inside at a depth above 1e-5
    and 0 elsewhere (on-surface points would turn fp noise into huge
    gradients); it carries no derivative.  The field (the vertices) gets
    a zero derivative, as the reference's detached grid."""

    generate_vmap_rule = True

    @staticmethod
    def forward(points, verts, faces):
        phi, closest, inside = _sdf_at_points_impl(points, verts, faces)
        live = inside & (phi > 1e-5)
        g = torch.where(live[:, None], (points - closest)
                        / torch.clamp_min(phi, 1e-5)[:, None], 0.0)
        return phi, g

    @staticmethod
    def setup_context(ctx, inputs, output):
        g = output[1]
        ctx.mark_non_differentiable(g)
        ctx.save_for_backward(g)
        ctx.save_for_forward(g)

    @staticmethod
    def jvp(ctx, p_dot, v_dot, f_dot):
        g, = ctx.saved_tensors
        return torch.sum(g * p_dot, dim=-1), None

    @staticmethod
    def backward(ctx, phi_bar, g_bar):
        g, = ctx.saved_tensors
        return g * phi_bar[:, None], None, None


def sdf_at_points(points: torch.Tensor, verts: torch.Tensor,
                  faces: torch.Tensor) -> torch.Tensor:
    """Exact phi (N,) at points (N, 3) in the field of one mesh (V, 3):
    the gridless limit of `sdf_grid`.  The derivative in points is the
    unit direction away from the nearest surface point inside (0
    outside); the mesh is a constant.  Works under `torch.func.jvp`,
    `vmap` over tangents and `jacrev` while the primal is unbatched: call
    it once per mesh, never under a vmap over meshes or frames."""
    return _SdfAtPoints.apply(points, verts, faces)[0]


# ---------------------------------------------------------------------------
# Trilinear sampling + collision energy.
# ---------------------------------------------------------------------------

def _trilinear_corners(phi: torch.Tensor, coords: torch.Tensor):
    """Corner values and fractional offsets.

    phi: (B, G, G, G) [z, y, x]; coords: (B, M, 3) (x, y, z).  Returns
    (vals, fx, fy, fz): vals is a list of 8 (B, M) corner values in
    (dz, dy, dx) binary counting order; out-of-bounds corners give 0
    (padding_mode='zeros').  phi must carry no derivative: only the
    offsets do.
    """
    G = phi.shape[-1]
    pix = ((coords + 1.0) * G - 1.0) * 0.5
    x, y, z = pix[..., 0], pix[..., 1], pix[..., 2]
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    xi0, yi0, zi0 = (t.detach().to(torch.int64) for t in (x0, y0, z0))
    flat = phi.reshape(phi.shape[0], -1)

    vals = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dxi in (0, 1):
                zi, yi, xi = zi0 + dz, yi0 + dy, xi0 + dxi
                inb = ((zi >= 0) & (zi < G) & (yi >= 0) & (yi < G)
                       & (xi >= 0) & (xi < G))
                idx = ((zi.clamp(0, G - 1) * G + yi.clamp(0, G - 1)) * G
                       + xi.clamp(0, G - 1))
                v = torch.gather(flat, 1, idx)
                vals.append(torch.where(inb, v, torch.zeros_like(v)))
    return vals, fx, fy, fz


def grid_sample_trilinear(phi: torch.Tensor, coords: torch.Tensor
                          ) -> torch.Tensor:
    """Sample phi at normalized coords, as torch `grid_sample(...,
    align_corners=False, padding_mode='zeros')` does: pixel = ((c + 1) G
    - 1) / 2, trilinear weights, zero outside.

    phi: (G, G, G) with coords (..., 3), or (B, G, G, G) with coords
    (B, M, 3).  Written with plain gathers, not `F.grid_sample`, whose 3-D
    form has no forward-mode derivative; the tangent in coords is the
    trilinear spatial gradient (JAX's custom JVP, away from cell faces),
    and phi gets no tangent.
    """
    if phi.dim() == 3:
        shape = coords.shape[:-1]
        out = grid_sample_trilinear(phi[None], coords.reshape(1, -1, 3))
        return out.reshape(shape)
    vals, fx, fy, fz = _trilinear_corners(phi.detach(), coords)
    out = torch.zeros_like(fx)
    i = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dxi in (0, 1):
                w = ((fx if dxi else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))
                out = out + w * vals[i]
                i += 1
    return out


def box_frame(verts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-person normalization (`fitting.py:369-378`):
    verts (..., V, 3) -> (centers (..., 3), scales (...)), the box center
    and 1.2 x half the largest extent.  `amin`/`amax` split the
    derivative evenly between tied vertices, as JAX's reductions do."""
    lo = verts.amin(dim=-2)
    hi = verts.amax(dim=-2)
    centers = 0.5 * (lo + hi)
    scales = 1.2 * 0.5 * (hi - lo).amax(dim=-1)
    return centers, scales


def person_grids(verts: torch.Tensor, faces: torch.Tensor,
                 grid_size: int = 32
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Voxelize every mesh in its box frame, all meshes in one call.

    verts: (..., P, V, 3) plain tensors (no autograd or `torch.func`
    wrapping: on CUDA this launches the voxelizer kernels).  Returns
    (phi (..., P, G, G, G), centers (..., P, 3), scales (..., P)), all
    detached.
    """
    from .sdf_kernel import sdf_grid_fast
    verts = verts.detach()
    centers, scales = box_frame(verts)
    local = (verts - centers[..., None, :]) / scales[..., None, None]
    return sdf_grid_fast(local, faces, grid_size), centers, scales


def collision_sums_sampled(phi: torch.Tensor, centers: torch.Tensor,
                           scales: torch.Tensor, verts: torch.Tensor
                           ) -> torch.Tensor:
    """s_i = sum of phi_i at ALL persons' vertices (self included: the
    reference comments the self-weight zeroing out, `fitting.py:374-375`).

    phi: (..., P, G, G, G); centers (..., P, 3); scales (..., P); verts
    (..., P, V, 3).  Returns (..., P).
    """
    lead = verts.shape[:-3]
    P, V = verts.shape[-3], verts.shape[-2]
    G = phi.shape[-1]
    phi = phi.reshape((-1, P, G, G, G))
    centers = centers.reshape(-1, P, 3)
    scales = scales.reshape(-1, P)
    pts = verts.reshape(-1, P * V, 3)
    sums = []
    for i in range(P):
        local = (pts - centers[:, i, None, :]) / scales[:, i, None, None]
        sums.append(grid_sample_trilinear(phi[:, i], local).sum(dim=-1))
    return torch.stack(sums, dim=-1).reshape(lead + (P,))


def collision_sums(verts: torch.Tensor, faces: torch.Tensor,
                   grid_size: int = 32) -> torch.Tensor:
    """Per-person penetration sums (..., P) for verts (..., P, V, 3):
    grids voxelized at `verts` (detached), sampled in the live box
    frame.  Voxelizes, so call it on plain tensors; inside a transform
    hold the grids fixed with `collision_sums_sampled`."""
    phi, _, _ = person_grids(verts, faces, grid_size)
    return sampled_at_live_frame(phi, verts)


def sampled_at_live_frame(phi: torch.Tensor, verts: torch.Tensor
                          ) -> torch.Tensor:
    """`collision_sums_sampled` with the box frame recomputed from the
    live `verts`, which keeps its derivative (`sdf.py:1083-1090`)."""
    centers, scales = box_frame(verts)
    return collision_sums_sampled(phi, centers, scales, verts)


def collision_sums_points(verts: torch.Tensor, faces: torch.Tensor,
                          include_self: bool = False) -> torch.Tensor:
    """`collision_sums` in the G -> infinity limit (the points engine):
    phi evaluated exactly at the query vertices by `sdf_at_points`.

    verts (P, V, 3) or (V, 3).  Each person's mesh sits in its box frame
    of the detached vertices (the field is a constant); the queries sit
    in the live box frame, which keeps its derivative.  A body's own
    vertices lie on its surface, where the exact field is 0, so by
    default person i is queried with the other people's vertices,
    concatenated in order (JAX `ops/sdf.py:1093-1145`); `include_self`
    queries everyone's.  One field evaluation per person, so it runs
    under forward- and reverse-mode transforms of the vertices.  Returns
    (P,); zeros for P = 1 without self queries.
    """
    if verts.dim() == 2:
        verts = verts[None]
    P = verts.shape[0]
    field = verts.detach()
    centers_det, scales_det = box_frame(field)
    centers, scales = box_frame(verts)
    sums = []
    for i in range(P):
        if include_self:
            others = verts.reshape(-1, 3)
        elif P == 1:
            sums.append(verts.new_zeros(()))
            continue
        else:
            others = torch.cat([verts[j] for j in range(P) if j != i])
        mesh = (field[i] - centers_det[i]) / scales_det[i]
        q = (others - centers[i]) / scales[i]
        sums.append(torch.sum(sdf_at_points(q, mesh, faces)))
    return torch.stack(sums)


def collision_energy(verts: torch.Tensor, faces: torch.Tensor,
                     coll_weight, grid_size: int = 32) -> torch.Tensor:
    """Total interpenetration penalty sum_i (w s_i / P)^2 per leading
    index: verts (..., P, V, 3) -> (...)."""
    s = collision_sums(verts, faces, grid_size)
    return torch.sum((coll_weight * s / s.shape[-1]) ** 2, dim=-1)
