"""HybrIK twist-and-swing inverse kinematics over the SMPL skeleton
(port of `models/hybrik.py`), batched over people.

The reference's regressor feeds its joint skeleton and 23 twist angles
into `smpl.hybrik(pose_skeleton, betas, phis, ...)`
(`simple3dposeSMPLWithCam.py:329-335`); as in JAX this is the published
analytical IK against the port's SMPL assets:

* the rest skeleton comes from the shape blend (betas);
* the root rotation is the Kabsch rotation of the root's child bones
  (hips and spine) onto their targets (a 3x3 SVD, sign-safe by the
  determinant's sign);
* every other joint's local rotation is a swing (the least rotation
  taking the template bone to the target bone, both in the parent's
  frame) times a twist about the template bone by the regressed angle
  (cos, sin);
* leaves (feet, head and hands of the 24-joint skeleton) have no child
  bone, so their rotation is the identity; the network's five extra
  leaf joints are accepted and ignored.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .smpl import SMPLAssets, _rigid_chain

# Primary child of each SMPL joint (the first child in index order; -1
# for leaves): the bone of the swing solve.
_SMPL_CHILD = (1, 4, 5, 6, 7, 8, 9, 10, 11, 12, -1, -1, 15, 16, 17,
               -1, 18, 19, 20, 21, 22, 23, -1, -1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min(_norm(v), 1e-8)


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (..., 4) as (w, x, y, z) -> (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def _swing_between(b: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The least rotation (B, 3, 3) taking directions b to v (B, 3): the
    half-angle quaternion (1 + b.v, b x v); antiparallel pairs turn by
    pi about an axis orthogonal to b."""
    b, v = _unit(b), _unit(v)
    axis = torch.cross(b, v, dim=-1)
    c = (b * v).sum(-1, keepdim=True)
    q = torch.cat([1.0 + c, axis], dim=-1)
    n = _norm(q)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=b.dtype, device=b.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=b.dtype, device=b.device)
    ortho = torch.cross(b, ex.expand_as(b), dim=-1)
    ortho = torch.where(_norm(ortho) < 1e-6,
                        torch.cross(b, ey.expand_as(b), dim=-1), ortho)
    q_flip = torch.cat([torch.zeros_like(c), _unit(ortho)], dim=-1)
    q = torch.where(n < 1e-6, q_flip, q / torch.clamp_min(n, 1e-8))
    return _quat_to_mat(q)


def _twist_about(b: torch.Tensor, cos_sin: torch.Tensor) -> torch.Tensor:
    """Rotations (B, 3, 3) about axes b (B, 3) by the angles whose (cos,
    sin) (B, 2) are given (normalized first)."""
    b = _unit(b)
    cs = _unit(cos_sin)
    c, s = cs[:, :1, None], cs[:, 1:, None]
    zero = torch.zeros_like(b[:, 0])
    K = torch.stack([torch.stack([zero, -b[:, 2], b[:, 1]], -1),
                     torch.stack([b[:, 2], zero, -b[:, 0]], -1),
                     torch.stack([-b[:, 1], b[:, 0], zero], -1)], -2)
    eye = torch.eye(3, dtype=b.dtype, device=b.device)
    return eye + s * K + (1 - c) * (K @ K)


def _kabsch(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """R (B, 3, 3) minimizing ||R src - dst|| over rotations; src/dst
    (B, K, 3).  U diag(1, 1, sign det(U Vt)) Vt, so the signs the SVD
    picks for its vectors do not change R."""
    M = dst.transpose(1, 2) @ src
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag_embed(torch.stack([torch.ones_like(d),
                                      torch.ones_like(d), d], -1))
    return U @ D @ Vt


def _rest_joints(assets: SMPLAssets, betas: torch.Tensor) -> torch.Tensor:
    """(B, 24, 3) rest joints of the shaped template."""
    dtype = assets.v_template.dtype
    v_shaped = assets.v_template + torch.einsum(
        "vct,bt->bvc", assets.shapedirs, betas.to(dtype))
    return torch.einsum("jv,bvc->bjc", assets.j_regressor[:24], v_shaped)


def hybrik_ik(assets: SMPLAssets, skeleton: torch.Tensor,
              betas: torch.Tensor, phis: torch.Tensor,
              swing_cos: Optional[list] = None) -> torch.Tensor:
    """Analytical IK: joint targets + twists -> local rotations.

    skeleton (B, 24 or 29, 3) root-relative targets in the template's
    metric frame (rows past 24 ignored); betas (B, NB); phis (B, 23, 2)
    the (cos, sin) twists of joints 1-23.  Returns (B, 24, 3, 3), root
    first.  `swing_cos`, when given, gets each swing's cosine between
    the template and target bones (B,): near -1 the swing's axis is
    ill-conditioned (a bone turned back on itself).
    """
    skel = skeleton[:, :24]
    skel = skel - skel[:, :1]
    j_rest = _rest_joints(assets, betas)
    j_rest = j_rest - j_rest[:, :1]
    parents = assets.parents[:24]
    root_children = [i for i in range(1, 24) if parents[i] == 0]
    R_root = _kabsch(j_rest[:, root_children], skel[:, root_children])
    eye = torch.eye(3, dtype=skel.dtype, device=skel.device).expand_as(
        R_root)
    glob, local = [R_root], [R_root]
    for i in range(1, 24):
        p, child = parents[i], _SMPL_CHILD[i]
        if child < 0:
            R_local = eye
        else:
            b = j_rest[:, child] - j_rest[:, i]
            d_t = skel[:, child] - skel[:, i]
            v = (glob[p].transpose(1, 2) @ d_t[..., None])[..., 0]
            if swing_cos is not None:
                swing_cos.append((_unit(b) * _unit(v)).sum(-1))
            R_local = _swing_between(b, v) @ _twist_about(b, phis[:, i - 1])
        local.append(R_local)
        glob.append(glob[p] @ R_local)
    return torch.stack(local, dim=1)


def twist_angles(assets: SMPLAssets, betas: torch.Tensor,
                 rot_mats: torch.Tensor) -> torch.Tensor:
    """The (cos, sin) twists (B, 23, 2) of local rotations (B, 24, 3, 3)
    about their template bones: the inverse of the twist half, for
    round-trip checks (IK(FK(pose), twists(pose)) == pose)."""
    j_rest = _rest_joints(assets, betas)
    out = []
    for i in range(1, 24):
        child = _SMPL_CHILD[i]
        if child < 0:
            out.append(torch.tensor([1.0, 0.0], dtype=rot_mats.dtype,
                                    device=rot_mats.device).expand(
                rot_mats.shape[0], 2))
            continue
        b = _unit(j_rest[:, child] - j_rest[:, i])
        R = rot_mats[:, i]
        tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
        w = 0.5 * torch.sqrt(torch.clamp_min(1.0 + tr, 1e-12))
        xyz = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                           R[:, 1, 0] - R[:, 0, 1]], -1) / torch.clamp_min(
            4 * w, 1e-8)[:, None]
        tq = _unit(torch.stack([w, (xyz * b).sum(-1)], -1))
        ch, sh = tq[:, 0], tq[:, 1]
        out.append(torch.stack([ch * ch - sh * sh, 2 * ch * sh], -1))
    return torch.stack(out, dim=1)


def forward_rotmats(assets: SMPLAssets, betas: torch.Tensor,
                    rot_mats: torch.Tensor,
                    scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LBS from local rotation matrices (B, J, 3, 3) (`smpl.lbs` without
    the axis-angle step): (verts (B, V, 3), posed joints (B, J, 3))."""
    B, J = rot_mats.shape[:2]
    dtype = assets.v_template.dtype
    v_shaped = assets.v_template + torch.einsum(
        "vct,bt->bvc", assets.shapedirs, betas.to(dtype))
    j_rest = torch.einsum("jv,bvc->bjc", assets.j_regressor[:J], v_shaped)
    eye = torch.eye(3, dtype=dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + (pose_feature @ assets.posedirs).reshape(B, -1, 3)
    s = (torch.ones(B, dtype=dtype, device=rot_mats.device)
         if scale is None else scale)
    posed_joints, A = _rigid_chain(rot_mats, j_rest,
                                   tuple(assets.parents[:J]), s)
    T = (assets.lbs_weights @ A.reshape(B, J, 16)).reshape(B, -1, 4, 4)
    verts = (torch.einsum("bvac,bvc->bva", T[..., :3, :3], v_posed)
             + T[..., :3, 3])
    return verts, posed_joints
