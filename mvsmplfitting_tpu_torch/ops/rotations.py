"""Rotation representations and conversions (PyTorch, batch-first).

Port of `mvsmplfitting_tpu/ops/rotations.py`: the same formulas and the
same quirks (rodrigues' per-component +1e-8 shift, the 1e-12 Gram-Schmidt
floors, Shepperd's 1e-6 pivot floor with first-max-wins selection, the
sign-folded atan2).  Floors are `_floor`, whose derivative splits evenly
at a tie exactly as `jnp.maximum`'s does (`clamp_min` would not).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _floor(x: torch.Tensor, value: float) -> torch.Tensor:
    """max(x, value) whose derivative splits evenly at a tie, as
    `jnp.maximum`'s does.  Written with `where` because forward mode
    through `torch.maximum` can promote the tangent to float64."""
    c = torch.full_like(x, value)
    return torch.where(x > c, x, torch.where(x < c, c, 0.5 * (x + c)))


def rodrigues(rot_vecs: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3).

    The angle is ``norm(theta + 1e-8)`` with the epsilon added to each
    component, as the reference does (`lbs.py:290`).
    """
    angle = torch.linalg.vector_norm(rot_vecs + _EPS, dim=-1, keepdim=True)
    axis = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = axis.unbind(-1)
    zeros = torch.zeros_like(rx)
    K = torch.stack([zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros],
                    dim=-1).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotations (..., 3, 3) and translations (..., 3) -> (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def matrix_to_quaternion(R: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4), w-first.

    Shepperd's method: of the four pivot candidates the largest wins,
    the first one on a tie (`torch.argmax` returns the first maximum).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    t_w = 1.0 + m00 + m11 + m22
    t_x = 1.0 + m00 - m11 - m22
    t_y = 1.0 - m00 + m11 - m22
    t_z = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(_floor(x, eps))

    sw = safe_sqrt(t_w)
    q_w = torch.stack([sw, (m21 - m12) / sw, (m02 - m20) / sw,
                       (m10 - m01) / sw], -1)
    sx = safe_sqrt(t_x)
    q_x = torch.stack([(m21 - m12) / sx, sx, (m01 + m10) / sx,
                       (m02 + m20) / sx], -1)
    sy = safe_sqrt(t_y)
    q_y = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy,
                       (m12 + m21) / sy], -1)
    sz = safe_sqrt(t_z)
    q_z = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                       (m12 + m21) / sz, sz], -1)

    traces = torch.stack([t_w, t_x, t_y, t_z], dim=-1)
    best = torch.argmax(traces, dim=-1)
    cands = torch.stack([q_w, q_x, q_y, q_z], dim=-2)      # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = 0.5 * torch.gather(cands, -2, idx)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4), w-first -> axis-angle (..., 3).

    theta = 2 atan2(|v|, w), sign-folded so the angle lies in [-pi, pi].
    """
    w = q[..., 0]
    v = q[..., 1:]
    sin_sq = torch.sum(v * v, dim=-1)
    sin_theta = torch.sqrt(_floor(sin_sq, 0.0))
    two_theta = 2.0 * torch.where(w < 0.0,
                                  torch.atan2(-sin_theta, -w),
                                  torch.atan2(sin_theta, w))
    k = torch.where(sin_sq > 0.0,
                    two_theta / _floor(sin_theta, 1e-30),
                    torch.full_like(sin_sq, 2.0))
    return v * k[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4), w first -> rotation matrices (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternions (..., 4), w first (the
    angle of `aa + 1e-8`, as `rodrigues` takes it)."""
    angle = torch.linalg.vector_norm(aa + _EPS, dim=-1, keepdim=True)
    half = 0.5 * angle
    return torch.cat([torch.cos(half), aa * (torch.sin(half) / angle)],
                     dim=-1)


def matrix_to_sixd(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> the 6D representation (..., 6):
    the first two columns as (..., 3, 2) flattened, `sixd_to_matrix`'s
    layout."""
    return R[..., :, :2].reshape(R.shape[:-2] + (6,))


def euler_angles_to_matrix(euler: torch.Tensor,
                           convention: str = "XYZ") -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrices R = R_c0(a0) @ R_c1(a1)
    @ R_c2(a2) for the axes of `convention` (three of "X", "Y", "Z", as
    PyTorch3D's convention strings, which the reference bundles)."""
    def axis_rot(axis: str, a: torch.Tensor) -> torch.Tensor:
        c, s = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        if axis == "X":
            rows = [one, zero, zero, zero, c, -s, zero, s, c]
        elif axis == "Y":
            rows = [c, zero, s, zero, one, zero, -s, zero, c]
        elif axis == "Z":
            rows = [c, -s, zero, s, c, zero, zero, zero, one]
        else:
            raise ValueError(f"euler convention {convention!r}: axis "
                             f"{axis!r} is not X, Y or Z")
        return torch.stack(rows, -1).reshape(a.shape + (3, 3))

    if len(convention) != 3:
        raise ValueError(f"euler convention {convention!r}: three axes")
    mats = [axis_rot(ax, euler[..., i]) for i, ax in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def sixd_to_matrix(sixd: torch.Tensor) -> torch.Tensor:
    """Continuous 6D representation (..., 6) -> rotation matrices.

    Reshaped to (..., 3, 2); Gram-Schmidt on the two columns, completed
    by a cross product; the result's columns are [b1 b2 b3].
    """
    a = sixd.reshape(sixd.shape[:-1] + (3, 2))
    a1, a2 = a[..., 0], a[..., 1]
    b1 = a1 / _floor(torch.linalg.vector_norm(a1, dim=-1, keepdim=True),
                     1e-12)
    dot = torch.sum(b1 * a2, dim=-1, keepdim=True)
    b2u = a2 - dot * b1
    b2 = b2u / _floor(torch.linalg.vector_norm(b2u, dim=-1, keepdim=True),
                      1e-12)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)
